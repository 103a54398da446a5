"""Smoke run of vitta_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from this checkout, checks each against its plain PyTorch version, and
drives the TANet float32 and bfloat16 ViTTA streams under each of their
three regularization modes and as the epoch-style loop, the bfloat16
trajectory against the float32 one, the Video Swin-B float32 forward
paths and the Video Swin-B float32 ViTTA stream end to end, the last under
each of its four attention routes, Video Swin-T's forward paths and stream
under two of them, the Video Swin-B and Swin-T bfloat16 streams (Swin-T's
under both of those routes, Swin-B's also under the two projection-fused
routes and under cossim and the epoch-style loop) with their trajectories
against float32, and the loader chain (list of videos, datasets, the
pinned-memory Prefetcher, tta_stream) on TANet and Swin-B, whose host
library it builds with g++, then the six baselines and the CLI's
corruption sweep with a mid-stream checkpoint and ``--resume``, then the
model zoo (VideoMAE ViT-B, R(2+1)D-18, I3D-ResNet 18 and 50,
Inception-I3D, TANet without the TAM) at full width and the Kinetics-400-C
and SSv2-C drivers, then stream parallelism (two TANet streams as two
processes sharing the card, the parallel sweep killed and resumed,
``sharded_validate``), the trainer and the entry's multi-process dry run,
then Video Swin's layout variants (window-resident stages, the patch
embedding as a product) card against CPU and, at full size, in turns with
the default form.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. device: needs CUDA; prints the card's name and power limit.
2. build: every ``vitta_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, all
   at once.
3. TAM kernels against plain: the dynamic conv forward and backward at
   every TAM shape of ResNet-50 (n=2 adapt, n=1 eval, t=16, and t=3 for
   the zero-padded ends), values; CUDA-event and device times at the adapt
   batch, the shapes its sums are made of.
4. Video Swin kernels against plain: LayerNorm, bias expansion, packed
   window attention (with and without mask, dense and compact bias) and
   LayerNorm-MLP at every Swin-B stage shape for 1 and 2 clips; values,
   CUDA-event and device times of kernel, plain version and, where one
   PyTorch call computes the same function, that call.  Then their four
   backward kernels (LayerNorm, bias collapse, attention with and without
   mask and with dense and compact bias, LayerNorm-MLP with and without a
   cotangent on y) at every stage shape for 2 clips, the adapt batch, each
   output against the plain backward version, the attention's also for 1
   clip (values only), where the last two stages have fewer problems than
   the card has SMs and blocks share them.  The LayerNorm backward also at
   every Swin-T site (widths 96 to 1536); each call holds the kernel's plan
   to ``ln_bwd_plan``, makes 2 launches and gives the same bits twice, each
   collapse 1 launch; their device us per site beside the bound and the
   rate.  Launches per call are read from the libraries' own counts
   (csrc/launches.cuh): every attention backward call's are its kernel,
   the sum of the blocks' shares of dk and dv where problems are shared,
   the sum of dl over the windows.  The library calls timed beside them
   are ``F.layer_norm``'s backward, one ``index_add`` over a flat map from
   dB to dV (what autograd makes of the expansion's gather) and
   ``scaled_dot_product_attention``'s backward, which gives dq, dk and dv
   and no bias gradient.
5. TANet slice at small size: full-width TANet at T=2, 32x32, two
   tta_online steps on the card and on the CPU from one seeded state dict:
   losses, logits, updated parameters, EMA.
6. TANet slice at full size: 101 classes, 2 views x 16 frames x 224x224,
   the reference operating point (tanet_ucf101_preset), through
   ``tta_stream`` over seeded synthetic uint8 videos; the TAM launch
   counters must show 16 forward launches per forward pass and 16
   backward launches per step, the BatchNorm-statistics counters one
   forward and one backward launch per step at each of the 29 chosen
   BatchNorm layers (layer3 and layer4, from ``select_tap_names``) and none
   in the eval forward.  Then one profiled step: host time, device busy,
   idle share, and the busy time by class of kernel.
7. Swin slice at small size: the tiny config of tests/test_swin_parity.py
   (shifted windows, clamped windows, PatchMerging padding): source
   statistics and eval logits on the card against the CPU.
8. Swin-B at full width and cut depth (2, 2, 2, 1), one 16x224x224 clip:
   every tap statistic and the logits on the card against the CPU.
9. Swin-B slice at full size: swin_ucf101_preset, depths (2, 2, 18, 2),
   ``compute_source_statistics`` over batches of 2 clips, the statistics
   files written and reloaded, then ``eval_step`` over single videos; per
   forward pass the counters must show 29 LayerNorm, 24 bias, 24
   attention and 24 LayerNorm-MLP launches and no contiguity copy.

10. Swin adapt slice at small size: the tiny config again, drop-path and
   head dropout 0, two tta_online steps on the card and on the CPU from
   one seeded state dict: losses, logits, updated parameters, EMA.
11. Swin-B adapt slice at full size: swin_ucf101_preset, depths
   (2, 2, 18, 2), drop-path 0.2 and head dropout 0.5 on, the statistics of
   phase 9, ``tta_stream`` over seeded synthetic uint8 videos (2 views and
   1 eval clip each); per video the counters must show 2 x (29, 24, 24,
   24) forward launches and 29 / 24 / 24 / 24 backward launches of
   LayerNorm / bias collapse / attention / LayerNorm-MLP.

12. Projection-fused attention kernels against plain: ``attn_proj`` and
   ``attn_ln_proj`` (qkv projection, window attention and output
   projection in one op, without and with the LayerNorm in front) at every
   Swin-B stage shape, forward for 1 clip (values only) and 2 clips,
   backward for 2 clips, with and without mask, the LayerNorm form with
   and without a cotangent on y: every output (the forward's qkv, and y,
   among them; the backward reads them), two backward runs bit-equal, the
   backward's launches per call within its budget (at most 8 without the
   LayerNorm and 11 with it, 2 fewer where both pairs of products run as
   one launch each; no qkv product, no LayerNorm forward, no column-sum
   pass), CUDA-event and device times of kernel and plain version; for ``attn_proj`` the library call
   ``F.multi_head_attention_forward`` (packed in-projection, attn_mask =
   bias + mask made outside the timed call, ``need_weights=False``) and
   its backward under autograd, which gives no bias gradient; no one call
   computes the LayerNorm form with its second output y.  Beside both,
   the device time of the composition the op replaces (LayerNorm kernel,
   ``F.linear``, packed attention kernel, ``F.linear``).
13. Small slices of the two projection-fused routes: the tiny Swin under
   ``attn_route="proj"`` and ``"ln_proj"``, source statistics and eval
   logits (as phase 7) and two tta_online steps (as phase 10) on the card
   against the CPU.
14. Swin-B slices of the two routes at full size: under ``"ln_proj"`` the
   precompute and ``eval_step`` of phase 9 (statistics and logits must
   agree with phase 9's packed route) and ``tta_stream`` over 5 videos;
   under ``"proj"`` ``tta_stream`` over 3 videos.  Per forward pass the
   counters must show, under ``"ln_proj"``, 24 ``attn_ln_proj``, 5
   LayerNorm, 24 bias and 24 LayerNorm-MLP launches, no packed attention
   and no contiguity copy, per step as many backward launches; under
   ``"proj"`` 29 LayerNorm and 24 ``attn_proj``.  Then one adapt+eval
   step under packed, proj and ln_proj in turns (packed, proj, ln_proj,
   ln_proj, proj, packed; one engine each): device busy and the step's
   peak memory above what the engines hold.  Ends with one line per route:
   ms/video, host time, device busy, idle share, peak memory, and for
   these three the interleaved device busy and step peak.

15. MLP kernels without the LayerNorm and attention kernels per (head,
   window) against plain, forward and backward, at every Swin-T and every
   Swin-B stage shape for 2 clips, the attention with and without mask on
   q, k, v as views of a packed projection output: every output, two
   backward runs bit-equal, the attention backward (from the row maximum
   and sum its forward kept) making the packed backward's launches and none
   of the forward kernel, CUDA-event and device times of kernel and plain
   version; beside the MLP the ``F.linear``-``F.gelu``-``F.linear``
   composition and its backward under autograd, beside the attention
   ``scaled_dot_product_attention`` and its backward.
16. Small slices of the ``"heads"`` route and of both branches of the MLP
   (norm2 inside the LayerNorm-MLP kernel where the width is a multiple of
   128, apart otherwise): the tiny Swin under ``attn_route="heads"``, and
   embed 16 over four stages at 48x48 (widths 16 to 128) under ``"heads"``
   and packed; source statistics, eval logits and two tta_online steps on
   the card against the CPU, as phases 7 and 10.
17. Video Swin-T at full size (embed 96, depths (2, 2, 6, 2), heads
   (3, 6, 12, 24), otherwise swin_ucf101_preset): the precompute and
   ``eval_step`` of phase 9 and ``tta_stream`` over 6 videos on the packed
   route, then both again under ``"heads"`` (statistics and logits must
   agree with the packed route's); per forward pass the counters must show
   21 LayerNorm (12 norm1, 4 norm2 of stages 1-2, 5 others), 12 bias, 4 MLP
   and 8 LayerNorm-MLP launches, 12 packed or 12 per-(head, window)
   attention launches and none of the other, per step as many backward
   launches, and no contiguity copy.  Then Swin-B's ``tta_stream`` over 3
   videos under ``"heads"``.

18. BatchNorm-statistics kernels against plain (``fused_bn_relu_stats``:
   BatchNorm in its inference form, optional ReLU, channel mean and
   variance of the output): forward and backward with cotangents on all
   three outputs, ``relu`` False and True, at every BatchNorm2d shape a
   TANet mean_var step reads (R from 1,568 to 25,088, C from 256 to 2,048)
   and the two BatchNorm1d shapes of a TAM; y, m, v, dx, dscale, dbias, two
   runs and a CUDA graph's replays bit-equal; one launch a call each way,
   from the library's counts; CUDA-event and device times of kernel and
   plain version per site beside the bound and summed over one adapt pass.
   No one PyTorch call returns y and the statistics, so the library time
   is none; the composition ``F.batch_norm`` (eval form) +
   ``torch.var_mean`` is timed beside it.
19. Small slices of the engine's other modes, card against CPU, two steps
   each as phase 5: TANet under BNS (``running_manner`` True and False),
   under cossim (``l1_loss``), with Adam on the norm layers' affine
   parameters, and through ``tta_epoch_adapt``; the tiny Swin of phase 10
   under cossim.
20. TANet at full size in those modes: a 3-video ``tta_stream`` under BNS
   and one under cossim (one warm-up each; the BatchNorm-statistics
   kernels must not run: neither reads the output's spatiotemp leaf), and
   ``tta_epoch_adapt`` over 3 videos with its ``validate`` pass (29 forward
   and 29 backward launches per step).  Ends with one line per mode:
   ms/video, host time, device busy, idle share, peak memory.
21. gemm_tiles' rates: at every Swin-B and Swin-T stage shape of 2 clips,
   float32-equivalent TFLOP/s (2MNK over the device time of its launches)
   of the MLP's forward and backward products and, at Swin-B's, of the
   projection-fused attention's, beside ``torch.matmul`` (TF32 off) on the
   same products; one line per shape and one JSON line of them all.
22. The TAM and BatchNorm-statistics kernels at bfloat16 (rows 1, 2 and 7
   in the bfloat16 TANet: bfloat16 activations and cotangents, float32
   attn, weights, parameters, statistics and their gradients) against
   their plain versions, which round at the same points: every TAM shape
   of phase 3 at n=2 and n=1 with t=16 and at t=3, the BatchNorm shapes of
   phase 18 with ``relu`` False and True.  The TAM's out and dx must be the
   plain versions' bits, dattn and dkernel within GRAD_TOL; the
   BatchNorm's y and dx within one bfloat16 ulp, its statistics within
   BN_TOL (variance rtol 1e-4 / atol 1e-5), dscale and dbias within
   BN_BWD_TOL; launches per call from the libraries' counts, of the
   bfloat16 instances only (one a call each way: the TAM backward's
   ``tam_bwd_bf16x8_kernel`` adds its blocks' rows itself, its plan the
   mirror's ``bwd_plan_bf16``); two runs, a call on another stream and
   CUDA graph replays of each backward bit-equal; a view 2 bytes past a
   16-byte boundary takes each kernel's one-value path.  Device ms per
   site and per adapt pass beside the bound at bfloat16's bytes, and the
   plain versions' (and the BatchNorm's ``F.batch_norm`` +
   ``torch.var_mean`` composition at bfloat16).
23. TANet at bfloat16 (``compute_dtype="bfloat16"``; float32 masters,
   SGD, losses, EMA and statistics): the small slice of phase 5 card
   against CPU, held to tests/test_torch_bf16_engine.py's bounds, then the
   full slice of phase 6 over 5 videos: ms/video, host time, device busy,
   idle share, busy by class of kernel, peak memory, per video 32 TAM
   forward and 16 backward launches and 29 + 29 BatchNorm-statistics
   launches, every one of them a bfloat16 kernel by the libraries' own
   counts (so no plain version ran) and none a float32 one; the TAM
   backward 16 launches a video, one a call (32 at float32).  Then under
   ``stat_reg="BNS"``, ``"cossim"`` and as ``tta_epoch_adapt``: the small
   slice card against CPU at the same bounds (the epoch-style loop's top-1
   exactly) and a full stream of BF16_MODE_VIDEOS videos each, as phase 20
   runs them at float32.
24. float32 against bfloat16 trajectories on the card: the same float32
   masters, source statistics and 40 seeded uint8 videos through
   ``adapt_eval_step`` at each dtype; prints the quantities of
   benchmarks/results/bf16_gate_tanet.json (prediction agreement, top-1,
   the largest reg and consistency loss differences, the final reg loss's
   relative difference, parameter and EMA relative L2 drift) and holds
   them to GATE_BOUNDS.

25. The LayerNorm, LayerNorm-MLP and packed attention kernels at bfloat16
   (rows 3, 4, 10, 11, 14 and 15 in the bfloat16 Swin: activations,
   weights and their gradients bfloat16, gamma, beta, bias, mask, row
   statistics, dgamma, dbeta and dbias float32) against their plain
   versions, which round where vitta_tpu's Pallas kernels round at
   bfloat16: every Swin-B LayerNorm site and stage shape at 1 and 2 clips,
   forward and backward (the attention's backward also at 1 clip, dense and
   compact bias), held by vitta_tpu_torch/tools/bf16_checks.py (one
   bfloat16 ulp; every step of the LayerNorm-MLP and the attention from the
   kernel's own rounded intermediates, read from its outputs, its
   backward's scratch and the attention's instances that write bfloat16(e),
   and those intermediates against their plain values; end to end the
   attention's out and dqkv at most 1e-4 of the values beyond one ulp, those
   within 2^-7 of the absolute products through e and dl); two backward
   runs bit-equal; launches per call, of bfloat16 instances only (the
   LayerNorm backward one ``ln_bwd_bf16x8`` launch a call, its plan the
   mirror's ``ln_bwd_bf16_plan``, repeats, another stream and CUDA graph
   replays bit-equal; also at every Swin-T site, with its device ms per
   Swin-T pass); a
   LayerNorm view 2 bytes past a 16-byte boundary on the one-value path.
   The attention's forward on the compact bias gives the dense bias's row
   maxima and e bit for bit, its row sums within ATTN_TOL and out within one
   ulp (the two kernels sum s and o in their own orders); its backward's
   compact dbias is the kernel's own dl collapsed per window
   and added in window order, bit for bit, and its scratch smaller than
   one (B_, nh, N, N) dl.  Each row's ``max_abs_err`` is the largest
   difference of any of its outputs, bfloat16 and float32, from the plain
   version it is held to.  Device ms per Swin-B pass of 2 clips beside the
   bound at bfloat16 (bytes over 3.35 TB/s, operations over 989 TFLOP/s),
   the float32 kernel's on the same values, the plain versions' and the
   library calls' (F.layer_norm and its backward, sdpa with the bias as
   attn_mask and its backward, with the bias's gradient for the attention
   row, the backend named; the LayerNorm-MLP's F.layer_norm-F.linear-
   F.gelu-F.linear composition and its autograd backward beside it, no one
   call computing it); the attention rows on the compact bias the model
   hands them, the dense form's times beside them; the device times from
   CUDA graphs' replays (``graph_ms``), the libraries' backward from the
   profiler.
26. A small bfloat16 Swin (embed 128, depths (2, 1), heads (4, 8), window
   (2, 3, 3), 4 x 48 x 48: every width a multiple of 128, as Swin-B's):
   two tta_online steps on the card and on the CPU, held as phase 23's.
27. Swin-B at bfloat16 (``Recognizer3D(..., dtype="bfloat16")``, float32
   masters, SGD, losses and statistics; the float32 model's source
   statistics): ``tta_stream`` over 6 videos, per video the launches of
   phase 11 but the bias expansion and collapse (the attention takes the
   compact bias), every LayerNorm, LayerNorm-MLP and attention launch a
   bfloat16 kernel by the libraries' counts, the standalone LayerNorm
   backward one ``ln_bwd_bf16x8`` launch a call (29 a video, was 58);
   ms/video, peak memory and a profiled step: host, device busy, idle
   share, busy by class of kernel.  Then (after phase 29) under the modes
   vitta_tpu's engine runs on Video Swin beside ``mean_var``:
   ``stat_reg="cossim"`` and ``tta_epoch_adapt`` (BNS reads BatchNorm
   layers, which Video Swin has none of): phase 26's small slice card
   against CPU at its bounds, and Swin-B streams of BF16_MODE_VIDEOS
   videos, every Swin kernel launch a bfloat16 instance.
28. float32 against bfloat16 Swin-B trajectories over 40 videos, as phase
   24: the quantities of benchmarks/bf16_gate.py (swin), held to
   GATE_BOUNDS.
29. Swin-B adapt+eval steps in turns in one process, on one video: float32,
   bfloat16 with the engine's bfloat16 twin of the cast weights, bfloat16
   casting them at every use (3 rounds of the three and back): the host's
   time to enqueue each step and its wall time, and a profiled step of
   each: device busy, launches, the copy kernels' launches and time.

30. The MLP without the LayerNorm and the attention per (head, window) at
   bfloat16 (rows 8, 9, 12 and 13 in the bfloat16 Swin-T), held as phase
   25 holds its rows: the MLP at Swin-T's stages 1-2 (widths 96 and 192)
   forward at 1 and 2 clips and backward at 2, each step on its own a, dh
   and dhc, its plan the library's; the attention per (head, window) at
   every Swin-T stage (forward at 1 and 2 clips, backward at 2) and every
   Swin-B stage (2 clips, values only), with and without mask, on views of
   the packed projection output, each step on its own e and dl; the packed
   bfloat16 pair at Swin-T's head counts (3, 6, 12, 24), values only.  Two
   backward runs bit-equal, launches per call bfloat16 instances only.
   Device ms per Swin-T pass of 2 clips (graph replays) beside the bound at
   bfloat16, the float32 kernels', the plain versions', the MLP's
   F.linear-F.gelu-F.linear composition at bfloat16 and its autograd
   backward, sdpa with the dense bias and its backward with and without
   the bias's gradient.
31. A small bfloat16 Swin of Swin-T's first widths (embed 96, depths
   (2, 1), heads (3, 6), window (2, 3, 3), 4 x 48 x 48: norm2 apart from
   the MLP at both widths) under "packed" and "heads": two tta_online
   steps on the card and on the CPU, held as phase 26's.
32. Swin-T at bfloat16 (embed 96, depths (2, 2, 6, 2), heads (3, 6, 12,
   24); float32 masters, SGD, losses and statistics; phase 17's weights and
   source statistics): ``tta_stream`` over 6 videos on the packed route and
   3 under "heads", as phase 27: per video the launches of phase 17 but, on
   the packed route, the bias expansion and collapse, every LayerNorm,
   LayerNorm-MLP, MLP and attention launch a bfloat16 kernel.
33. float32 against bfloat16 Swin-T trajectories over 10 videos, as phase
   28, held to GATE_BOUNDS.
34. The projection-fused attention at bfloat16, with and without the
   LayerNorm, forward and backward (rows 16-19 in the bfloat16 Swin under
   "proj" and "ln_proj"), at every Swin-B and Swin-T stage shape: forward
   at 1 clip (values), and at 2 clips with and without the mask,
   ``attn_ln_proj`` with and without a cotangent on y, held by
   ``bf16_checks.check_proj_bf16``: qkv and out by the Dense bound (between
   the Dense sums of the plain product's bfloat16 neighbours, at most 1e-3
   of the values apart from the plain version), every other step within
   one bfloat16 ulp of its plain version on the kernel's own
   intermediates (o_att; g_att, dqkv, dl and dy from the backward's
   scratch; e from the attention's tapped instances), the attention end to
   end as phase 25's, the float32 intermediates and sums to 2e-5 of their
   largest magnitude; two backward runs bit-equal; the backward's launches
   the library's own count (``vitta_attn_proj_bwd_bf16_launches``), within
   8 and 11, every one a bfloat16 instance.
35. At Swin-B's shapes (2 clips), device ms per Swin-B pass of 2 clips
   (graph replays) of the four, beside the float32 kernels' on the same
   values, the plain versions', the bound at bfloat16,
   ``F.multi_head_attention_forward`` at bfloat16 for ``attn_proj`` (its
   backward under autograd) and the composition each replaces (the
   LayerNorm kernel, F.linear, the bfloat16 packed kernel on the dense
   bias, F.linear; its backward under autograd).
36. Phase 26's small bfloat16 Swin under "proj" and "ln_proj", card against
   CPU.
37. Swin-B at bfloat16 under "ln_proj" and under "proj": ``tta_stream`` over
   3 videos each, as phase 27, per pass 24 ``attn_ln_proj`` and 5 LayerNorm
   launches, or 24 ``attn_proj`` and 29, the bias expansion and collapse,
   no packed attention, no contiguity copy, every attention launch a
   bfloat16 instance; a profiled step each.
38. One adapt+eval step each of packed, proj and ln_proj at bfloat16 in
   turns, as phase 14's.
39. The loader chain of vitta_tpu's main_eval.py on TANet
   (``tanet_ucf101_preset``, ``TANetVideoDataset``: rows 1, 2 and 7) and
   Swin-B (``swin_ucf101_preset``, float32, packed, ``SwinVideoDataset``:
   rows 3-6, 10, 11, 14 and 15): ``make_video_source("synthetic")`` at
   UCF101's 240 x 320 frames -> ``PairedTTADataset(emit_uint8=True)`` ->
   ``Prefetcher`` (pinned host memory, a copy stream a worker) ->
   ``tta_stream`` over one warm-up video and LOADER_VIDEOS more.  The host
   library must have been built with g++ into build/vitta_tpu_torch/.  The
   loader-fed stream's predictions, losses and final parameters must equal
   those of the same items fed from numpy arrays in memory within the
   spread of two in-memory runs (cuDNN's deterministic algorithms for the
   check).  Then, from runs apart from the check over one warm-up video
   and LOADER_TIMED_VIDEOS more (longer than 8 workers' window, so that the
   workers run beside the steps), the feeds in turns (LOADER_ROUNDS
   rounds): ms/video in memory and through the loader at 1
   and min(8, usable cores) workers, the consumer's wait for each item,
   the loader's host ms per item alone, one item's host-to-device copy from
   pinned and from pageable memory, and the host's cores.
40. The six baselines (source, NORM, TENT, SHOT, DUA, T3A): first card
   against CPU at T=4, 64x64 over 4 videos in batches of 2 (top-1 equal,
   the adapted model's eval logits rtol 2e-3 / atol 2e-4, its running
   statistics within 2e-3 of each layer's largest, updates within 2% of
   their norm, TENT's and SHOT's, through batch statistics, 10% at the
   median tensor and 15% as a whole); then each
   through the port's ``cli.main_eval.evaluate`` on TANet at
   ``tanet_ucf101_preset`` over BASELINE_VIDEOS synthetic videos of
   240 x 320 frames (DUA with no_vids 2), and TENT and NORM on Swin-B
   packed over BASELINE_SWIN_VIDEOS: the wrappers' launch counts as the
   baseline's passes make them (the libraries' the same, no
   BatchNorm-statistics launch), then a timed second run: ms/video (host
   clock, synchronised) and peak memory, and a third under the profiler:
   device busy ms/video; one line a baseline.
41. The CLI: ``run_compute_stats`` writes TANet's source statistics files,
   then ``run_corruption_sweep`` over two corruptions (mean_var from those
   files, ``--stream_ckpt_every 2``, the loader with 2 workers); a sweep
   stopped by an exception at item 3 of the second corruption and run
   again with ``--resume`` ends bit-equal to an uninterrupted one: rows,
   parameters, buffers, momentum, EMA and every logged loss and top-1
   (cuDNN deterministic).

42. The model zoo's kernels at its shapes (``phase_zoo_kernels``): the
   float32 LayerNorm forward and backward (rows 3-4) at VideoMAE's
   (3136, 768) and (1568, 768), the MLP without the LayerNorm (rows 8-9) at
   (3136, 768, 3072), the BatchNorm-statistics pair (row 7) at every
   BatchNorm site of the zoo's CNNs on the adapt batch (read from one
   forward on the card), against the plain versions at phase 4's, 15's and
   18's tolerances, one launch a call, the instance that ran named (the
   one-column ``<1, ...>`` at R(2+1)D's odd and 2-mod-4 widths); times per
   pass of each model's chosen layers.
43. The model zoo card against CPU (``phase_zoo_small``): each model at
   T=4, 32 x 32 (Inception T=8), logits, every tap, one tta_online step
   (losses, EMA, eval logits, updates, top-1) at phase 40's bounds.
44. Each zoo model at full width (``phase_zoo_full``): 101 classes, 2
   views x 16 x 224², ``tta_stream`` over ZOO_VIDEOS videos under mean_var,
   the wrappers' launches held to ZOO_PREDICTED, no clone or copy in a
   CNN's forward; ms/video, device busy, idle share, peak memory.
45. The Kinetics-400-C and SSv2-C drivers (``phase_zoo_drivers``):
   ``compute_stats`` then one corruption of 2 synthetic videos each.

46. Two TANet float32 streams at full width as two processes of one
   torchrun group sharing the card (``tools/parallel_streams.py``), then
   each alone in its process: bit-equal (losses, logits, parameters, EMA),
   rows 1, 2 and 7 launched 32 / 16 / 29 + 29 a video in every process;
   ms/video a stream, videos/s overall, busy share, peak memory
   (``phase_parallel_streams``).
47. The parallel sweep (``run_parallel_sweep``) over two corruptions as 2
   spawned processes on the card (``parallel.mesh.SpawnedGroup``), killed
   after its first checkpoint and resumed: the uninterrupted rows and steps.
48. ``sharded_validate`` over those 2 processes, 5 videos of 8 classes in
   batches of 2 and a remainder, each label the class the source model
   ranks 0, 3, 6, 0 and 1: top-1 and top-5 those of a plain evaluation on
   the card (strictly between 0 and 100: a lost share, a half evaluated
   twice or a dropped remainder changes one of them), top-1 the source
   baseline's.
49. The trainer: card against CPU at T 2, 64², each step from the CPU's
   state, the whole update and momentum within 4 times the CPU's own
   one-ulp spread (at most 10%), a planted fault (no weight decay) beyond
   it; full size (4 clips of 16 x 224²): 16 + 16 TAM launches a step,
   ms/step, busy, peak memory, a checkpoint round trip bit-equal.
50. ``entry.entry()`` on the card and ``entry.dryrun_multichip(2)``.

51. Video Swin's layout variants (``VITTA_WINDOW_RESIDENT``,
   ``VITTA_PATCHIFY_V2``; each read when a model is built, and 0 for
   phases 1-50, ``main``), small slices card against CPU: phase 26's
   small Swin under each of LAYOUT_SMALL (window-resident on packed,
   heads, proj and ln_proj; the product patch embedding alone and with the
   window layout), at float32 (phase 10's bounds) and bfloat16 (phase
   26's); every flag taken as set, the window layout's counter
   (``models/swin.py:counters.window_resident_stages``) above 0 where it is
   on and 0 where it is off.
52. Swin-B at full size on the packed route, float32 and bfloat16, its
   forms (spatial, window-resident, the product patch embedding;
   LAYOUT_FORMS) one engine each, in turns: 3 rounds of 1 warm-up and 8
   videos a form; ms/video, a profiled step's device busy, idle share,
   launches and data-movement launches (rolls, copies, concatenations,
   gathers) and ms, the launches a step by wrapper (the same as the
   spatial form's), the step's peak memory; each form's per-video losses
   and eval logits held to the spatial form's (``phase_layout_turns``).
   Then float32 spatial against the product patch embedding once more
   with cuDNN's TF32 on, PyTorch's default that the scripts keep (the
   Conv3d in TF32, the product in float32), held to the bfloat16 bounds.
53. Swin-T at full size, packed and heads, window-resident against
   spatial: one round, the same readings.

Phases run in the order 1-4, 12, 15, 21, 18, 22, 5, 6, 23, 24, 19, 20,
23's other modes, 7-11, 13, 14, 16, 17, 26-29, 27's other modes, 31-33,
36-53, 21 at bfloat16, 25, 30, 34, 35 (25, 30, 34 and 35 last: the memory
of their CUDA graphs would stand in the streams' peaks).  No earlier full-size stream was cut for
phases 18 to 28.  To
leave the time to phases 10 and 11, phase 9 runs 3 statistics batches and
4 eval videos where it ran 4 and 5, and the TANet slice 5 videos where it
ran 6; to leave it to phases 12 to 14, phases 3 and 4 time each call over
6 and 7 runs (4 under the profiler) where they took 25 and 15 (20 and 10),
and phase 12 over 5 (3) and only at 2 clips, the shapes its sums are made
of; to leave it to phases 15 to 17, phase 3 times the adapt batch only.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and before that one JSON line of the
kernels (the bfloat16 rows named ``..._bf16``).  TF32 is switched off for
matmuls and convolutions, because the comparisons of every phase but
22-28 are float32 ones; those are bfloat16's, whose products and
convolutions run on the tensor cores at bfloat16 whatever the TF32
switch.

Each kernel's ``bound_ms`` is the least time the card could take for the
same work: the larger of the bytes the function must move (each input
read once, each output written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s, NVIDIA's published H100 SXM peaks.  The
attention kernels and gemm_tiles run their matrix products on the tensor
cores in split TF32; the rows of the kernels built on them (8-19 of
PERF.md's table) also carry ``tf32x3_floor_ms``, three tf32 products of
those products at the dense TF32 rate of 495 TFLOP/s.  The bfloat16 Swin
rows (phase 25) count their operations against the dense bfloat16
tensor-core rate, 989 TFLOP/s (``BF16_FLOP_PER_S``), and their bytes at
bfloat16 (float32 for the bias, mask, row statistics and parameters).
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

# the set-up shared with vitta_tpu_torch/tools/attention_routes.py; without
# the package beside this file the run ends here
from vitta_tpu_torch.tools.synthetic import (
    SWIN_MODELS, StepTimes as _StepTimes, device_breakdown,
    normalized_batches as _normalized_batches, swin_cfg as _swin_cfg,
    swin_model as _synthetic_swin, swin_weights as _swin_weights,
    videos as _videos)
from vitta_tpu_torch.ops._launch import launches_of
# every LayerNorm kernel site of one Swin-B and one Swin-T forward pass:
# (tokens per clip, C) -> sites
from vitta_tpu_torch.tools.bn_variants import BN_SITES
from vitta_tpu_torch.tools.ln_bias_sites import (SWIN_LN_SITES,
                                                 SWIN_T_LN_SITES)
from vitta_tpu_torch.tools.tanet_breakdown import (
    profile_step as _profile_step, tanet_cfg as _cfg,
    tanet_engine as _tanet_engine, tanet_source as _tanet_source)

ROOT = os.path.dirname(os.path.abspath(__file__))

# every TAM site of ResNet-50: (H, W, C) -> sites per forward pass
TAM_SITES = {(56, 56, 64): 3, (56, 56, 128): 1, (28, 28, 128): 3,
             (28, 28, 256): 1, (14, 14, 256): 5, (14, 14, 512): 1,
             (7, 7, 512): 2}
FWD_TOL = 1e-5    # tests/test_pallas_tam.py's tolerances
GRAD_TOL = 2e-4
N_VIDEOS = 5      # full-slice videos; the first two are warm-up
TANET_MODE_VIDEOS = 3   # the BNS, cossim and epoch-style streams; one warm-up
# the two BatchNorm1d shapes of a TAM (layer3's: g_bn (N*C, 2T), l_bn (N, T,
# C/4)), values only
BN1D_SHAPES = (((512, 32), "g_bn"), ((2, 16, 64), "l_bn"))
BN_TOL = 1e-5       # y and m; v rtol 1e-4 / atol 1e-5 (tests/test_pallas_
                    # stats.py's): E[y^2] - m^2 from sums in another order
BN_BWD_TOL = 2e-5   # of each gradient's largest value, as LN_BWD_TOL's kind
SEED = 0
BF16_VIDEOS = 5     # the bfloat16 TANet stream (phase 23); two warm-up
GATE_VIDEOS = 40    # phase 24's two streams, float32 and bfloat16
# Phase 24's bounds on the bfloat16 trajectory against the float32 one
# (TANet, tanet_ucf101_preset, lr 5e-5, seeded random weights), stated
# before its first run (PERF.md).  The TPU's run of
# benchmarks/bf16_gate.py (benchmarks/results/bf16_gate_tanet.json, 120
# videos) measured agreement 1.0, reg-loss final difference 6.5e-4,
# parameter drift 5.9e-7 and EMA drift 4.6e-4.  The bounds: 101 nearly
# equal logits of random weights can swap their argmax under bfloat16's
# rounding in a few videos (0.9); the reg loss sums |differences| of
# statistics that bfloat16 moves by ~2^-9 of their size (1e-2); the
# weights move by well under 1e-3 of their norm at lr 5e-5 in 40 steps, of
# which bfloat16 changes a few % (1e-4); the EMA follows the statistics
# (2e-2).  The consistency loss's largest difference is held to a tenth of
# its largest float32 value (it is an L1 sum of logit differences).
GATE_BOUNDS = {"pred_agreement": (">=", 0.9),
               "reg_loss_final_reldiff": ("<=", 1e-2),
               "params_rel_l2_drift": ("<=", 1e-4),
               "ema_rel_l2_drift": ("<=", 2e-2)}

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12       # float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12      # dense TF32 on the tensor cores
BF16_FLOP_PER_S = 989e12      # dense bfloat16 on the tensor cores

# Swin-B on a 16x224x224 clip, per stage: width C, heads, tokens per clip,
# windows per clip (= the shift mask's nW), blocks
SWIN_WINDOW = (8, 7, 7)
SWIN_STAGES = ((128, 4, 25088, 64, 2), (256, 8, 6272, 16, 2),
               (512, 16, 1568, 4, 18), (1024, 32, 392, 1, 2))
LN_TOL = 1e-5      # the same one-pass float32 formula, sums in another order
ATTN_TOL = 2e-5    # __expf and another summation order over 392 keys
MLP_TOL = 1e-4     # tiled float32 sums over K <= 4096 terms: between the
                   # typical sqrt(K)*eps = 4e-6 and the worst K*eps = 2.4e-4
SWIN_STAT_BATCHES = 3   # of 2 clips; the first is warm-up
SWIN_EVAL_VIDEOS = 4    # of 1 clip; the first is warm-up
SWIN_ADAPT_VIDEOS = 6   # of 2 views + 1 eval clip; the first two are warm-up
# Swin-T (embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24)): the same
# tokens and windows per stage as Swin-B
SWIN_T_STAGES = ((96, 3, 25088, 64, 2), (192, 6, 6272, 16, 2),
                 (384, 12, 1568, 4, 6), (768, 24, 392, 1, 2))
SWIN_T_STAT_EVAL_VIDEOS = 3   # Swin-T's eval videos; one warm-up
SWIN_T_VIDEOS = 6             # Swin-T's streams; two warm-up
SWIN_B_HEADS_VIDEOS = 3       # Swin-B's stream under "heads"; one warm-up
SWIN_T_BF16_VIDEOS = 6        # Swin-T's bfloat16 stream, packed; two warm-up
SWIN_T_BF16_HEADS_VIDEOS = 3  # and under "heads"; one warm-up
SWIN_T_GATE_VIDEOS = 10       # phase 33's two Swin-T streams
SWIN_LN_PROJ_VIDEOS = 5   # the ln_proj route's stream; two warm-up
SWIN_PROJ_VIDEOS = 3      # the proj route's stream; one warm-up
SWIN_PROJ_EVAL_VIDEOS = 3   # the ln_proj route's eval videos; one warm-up
BF16_PROJ_VIDEOS = 3      # each bfloat16 projection-fused stream; one warm-up
BF16_MODE_VIDEOS = 3      # each bfloat16 stream under cossim, BNS or the
                          # epoch-style loop (phases 23 and 27); one warm-up
LOADER_VIDEOS = 4         # phase 39's list a model, after one warm-up video
LOADER_TIMED_VIDEOS = 16  # its timed streams: longer than 8 workers' window,
                          # so that the workers run beside the steps
LOADER_ROUNDS = 2         # phase 39's rounds of the feeds in turns
LOADER_FRAME = (240, 320)   # UCF101's frame size (height, width)
# backward kernels: |error| <= tol * (largest |value| of the plain version's
# tensor).  The sums over rows and windows are taken in chunks and the
# chunks added in order, not in the plain version's order; float32
# throughout, the attention's products in split TF32.  Measured on an H100:
# at most 1e-6 (LayerNorm), 5e-6 (attention), 3e-6 (LayerNorm-MLP, dx after
# two sums over up to 4096 terms).
LN_BWD_TOL = 1e-5
ATTN_BWD_TOL = 2e-5
MLP_BWD_TOL = 2e-5
# the projection-fused attention: |error| <= tol + tol * |value| forward, as
# MLP_TOL (its qkv comes from a tiled float32 sum over K <= 1024 terms, goes
# through the softmax of ATTN_TOL and a second such sum), and tol * (largest
# |value|) backward, as MLP_BWD_TOL with room for the two further products
# and the attention's in the chain
PROJ_TOL = 1e-4
PROJ_BWD_TOL = 5e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20):
    """Device time per call of ``fn`` from torch.profiler: the summed
    durations of the kernels it launched, over ``reps`` calls.  Unlike
    ``cuda_ms`` it leaves out the host's launch overhead; None when the
    profiler records no kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.self_device_time_total > 0]
        # every kernel name was launched in each of the calls: a count that
        # is no multiple of them means the trace lost events, so once more
        if events and all(e.count % reps == 0 for e in events):
            break
    us = sum(e.self_device_time_total for e in events)
    return us / 1e3 / reps if us > 0 else None


def check_close(name, got, want, rtol, atol=None):
    """Max abs error of ``got``; raises unless |got-want| <= atol +
    rtol*|want| everywhere (atol defaults to rtol)."""
    atol = rtol if atol is None else atol
    err = (got - want).detach().abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{name}: max abs error {float(err.max()):.3e} "
                             f"exceeds rtol={rtol} atol={atol}")
    return float(err.max())


def check_scaled(name, got, want, tol):
    """Max abs error of ``got``; raises unless it is at most ``tol`` times
    the largest magnitude in ``want``."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    err = float((got - want).detach().abs().max())
    scale = float(want.detach().abs().max())
    if not err <= tol * max(scale, 1e-30):
        raise AssertionError(f"{name}: max abs error {err:.3e} exceeds {tol} "
                             f"of the largest value {scale:.3e}")
    return err


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` operations at ``flop_rate`` (float32's
    by default; the bfloat16 rows' at the bfloat16 tensor-core rate)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flop_rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def measure(fn, reps: int = 7, dev_reps: int = 4, grad: bool = False):
    """(CUDA-event ms, device ms or None) of one call of ``fn``; the
    profiler is asked once more where it recorded no kernel."""
    with torch.set_grad_enabled(grad):
        event = cuda_ms(fn, reps=reps)
        device = device_ms(fn, reps=dev_reps)
        return event, device_ms(fn, reps=dev_reps) if device is None else device


def fmt(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def check_attn_bwd_launches(what, fn, split):
    """The launches of one attention backward call: attn_bwd_kernel, the
    sum of the blocks' shares of dk and dv where ``split`` > 1 blocks share
    a problem, the sum of dl over the windows; no forward kernel (the
    libraries' own counts).  Returns their number."""
    names = launches_of(fn)
    want = 2 + (split > 1)
    if (sum(names.values()) != want
            or any("attn_fwd_kernel" in k for k in names)
            or not any("attn_bwd_kernel" in k for k in names)):
        raise AssertionError(f"{what}: launches {names}, expected {want} "
                             "with attn_bwd_kernel and no forward kernel")
    return want


def check_proj_bwd_launches(what, fn, with_ln):
    """The launches of one projection-fused attention backward call, held to
    the chain's budget: the two pairs of products (one launch each where
    they are grouped, two otherwise), the attention backward (2 or 3), the
    LayerNorm backward's one (dx and its blocks' partials), one reduce for
    every partial sum; at most 8 without the LayerNorm and 11 with it, 2
    fewer where both pairs are grouped.  No qkv product (no gemm_tiles with
    two k-minor operands and the bias epilogue), no LayerNorm forward, no
    column-sum pass, no forward attention kernel (the libraries' own
    counts).  Returns the launches' count."""
    names = launches_of(fn)
    total = sum(names.values())
    pairs = sum(n for k, n in names.items() if "gemm_pair" in k)
    products = pairs + sum(n for k, n in names.items() if "gemm_tiles" in k)
    reduces = sum(n for k, n in names.items() if "reduce_sums" in k)
    budget = (11 if with_ln else 8) - pairs
    bad = [k for k in names if any(
        a in k for a in ("col_sums", "reduce_partials", "ln_rows_vec",
                         "ln_rows_any", "attn_fwd_kernel",
                         "false, false, 0>"))]
    if (total > budget or products != 4 - pairs or reduces != 1 or bad
            or not any("attn_bwd_kernel" in k for k in names)):
        raise AssertionError(f"{what}: launches {names}, {total} against a "
                             f"budget of {budget}")
    return total


class Totals:
    """Per-forward-pass sums of one kernel's measurements over its sites:
    ``add`` takes the sites' count and one site's numbers."""

    KEYS = ("ms", "plain_ms", "library_ms", "device_ms", "plain_device_ms",
            "library_device_ms", "bytes", "flops", "tc_flops")

    def __init__(self):
        self.sum = dict.fromkeys(self.KEYS, 0.0)
        self.err = 0.0

    def add(self, sites: int, **values):
        for key, v in values.items():
            if v is None or self.sum[key] is None:
                self.sum[key] = None      # one site not measured: no sum
            else:
                self.sum[key] += sites * v

    def row(self, name, source, replaces, has_library=True,
            flop_rate=FP32_FLOP_PER_S):
        ms, by = bound(self.sum["bytes"], self.sum["flops"], flop_rate)
        s = self.sum
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "max_abs_err": self.err, "ms": s["ms"],
               "plain_ms": s["plain_ms"], "bound_ms": ms, "bound_by": by,
               "library_ms": s["library_ms"] if has_library else None,
               "device_ms": s["device_ms"],
               "plain_device_ms": s["plain_device_ms"],
               "library_device_ms":
                   s["library_device_ms"] if has_library else None}
        if s["tc_flops"]:
            # products on the tensor cores in split TF32: three tf32
            # products for each, at the dense TF32 rate
            row["tf32x3_floor_ms"] = 3 * s["tc_flops"] / TF32_FLOP_PER_S * 1e3
        return row


# ---------------------------------------------------------------------------
def phase_tam_kernels(dev):
    """TAM kernel against plain on the card; returns its JSON rows."""
    from vitta_tpu_torch.ops.cuda_tam import (BWD_DEPTH, bwd_plan,
                                              bwd_plan_cuda,
                                              tam_bwd_cuda, tam_fwd_cuda,
                                              tam_dynamic_conv,
                                              tam_dynamic_conv_reference)
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"fwd": 0.0, "bwd": 0.0}
    per_step = dict.fromkeys(("fwd", "bwd", "plain_fwd", "plain_bwd"), 0.0)
    dev_step = dict.fromkeys(per_step, 0.0)
    # what one adapt step (16 sites, n=2, t=16) must move and do: forward
    # reads x, attn, K and writes out (1 multiply + 3 multiply-adds per
    # element); backward reads g and x again, writes dx, dattn, dK
    need = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    for (h, w, c), sites in TAM_SITES.items():
        # the adapt batch, one clip, three frames, and the backward's edge
        # cases: one frame, one past its chunk depth
        for n, t in ((2, 16), (1, 16), (2, 3), (2, 1), (2, BWD_DEPTH + 1)):
            x = torch.randn(n, t, h, w, c, device=dev, generator=gen)
            a = torch.sigmoid(torch.randn(n, t, c, device=dev, generator=gen))
            k = torch.softmax(torch.randn(n, c, 3, device=dev, generator=gen), -1)
            g = torch.randn(n, t, h, w, c, device=dev, generator=gen)
            ins = [v.clone().requires_grad_() for v in (x, a, k)]
            refs = [v.clone().requires_grad_() for v in (x, a, k)]
            out = tam_dynamic_conv(*ins)
            out.backward(g)
            ref = tam_dynamic_conv_reference(*refs)
            ref.backward(g)
            torch.cuda.synchronize()
            e_f = check_close(f"tam fwd {(n, t, h, w, c)}", out, ref, FWD_TOL)
            e_b = max(check_close(f"tam {nm} {(n, t, h, w, c)}", p.grad, q.grad,
                                  GRAD_TOL)
                      for nm, p, q in zip(("dx", "dattn", "dkernel"), ins, refs))
            err["fwd"], err["bwd"] = max(err["fwd"], e_f), max(err["bwd"], e_b)
            # no float atomics: two runs give the autograd run's bits
            again = tam_bwd_cuda(g, x, a, k)
            if not all(torch.equal(u, p.grad) for u, p in zip(again, ins)):
                raise AssertionError(f"tam bwd {(n, t, h, w, c)}: two runs "
                                     "differ")
            del again
            if (n, t) != (2, 16):   # held to plain; the adapt batch is timed
                print(f"tam n={n} t={t} {h}x{w}x{c}: err fwd {e_f:.2e} bwd "
                      f"{e_b:.2e}", flush=True)
                del x, a, k, g, ins, refs, out, ref
                continue

            plan = bwd_plan_cuda(n, t, h * w, c)
            if plan != bwd_plan(n, t, h * w, c):   # BWD_DEPTH is the kernel's
                raise AssertionError(f"tam bwd {(n, t, h, w, c)}: the kernel's"
                                     f" plan {plan} is not bwd_plan's")
            print(f"tam bwd n={n} t={t} {h}x{w}x{c}: two runs bit-equal; "
                  f"blocks {plan['ncc']} x {plan['npb']} x "
                  f"{n * plan['nseg']} of {plan['wc']} x {plan['slots']} "
                  f"threads, {plan['pp']} positions a thread, segments of "
                  f"{plan['seg_len']} frames", flush=True)
            ref = tam_dynamic_conv_reference(*refs)
            calls = {
                "fwd": lambda: tam_fwd_cuda(x, a, k),
                "bwd": lambda: tam_bwd_cuda(g, x, a, k),
                "plain_fwd": lambda: tam_dynamic_conv_reference(x, a, k),
                "plain_bwd": lambda: torch.autograd.grad(ref, refs, g,
                                                         retain_graph=True)}
            ev, dv = {}, {}
            for name, fn in calls.items():
                with torch.set_grad_enabled(name == "plain_bwd"):
                    ev[name], dv[name] = (cuda_ms(fn, reps=6, warmup=2),
                                          device_ms(fn, reps=4))
            nbytes = x.numel() * 4
            print(f"tam n={n} t={t} {h}x{w}x{c}: err fwd {e_f:.2e} bwd "
                  f"{e_b:.2e} | event ms: fwd {ev['fwd']:.4f} plain "
                  f"{ev['plain_fwd']:.4f}, bwd {ev['bwd']:.4f} plain "
                  f"{ev['plain_bwd']:.4f} | device ms: fwd {fmt(dv['fwd'])} "
                  f"plain {fmt(dv['plain_fwd'])}, bwd {fmt(dv['bwd'])} plain "
                  f"{fmt(dv['plain_bwd'])}", flush=True)
            small = (a.numel() + k.numel()) * 4
            need["fwd"][0] += sites * (2 * nbytes + small)
            need["fwd"][1] += sites * 7 * x.numel()
            need["bwd"][0] += sites * (3 * nbytes + 2 * small)
            need["bwd"][1] += sites * 14 * x.numel()
            for name in per_step:
                per_step[name] += sites * ev[name]
                if dev_step[name] is not None and dv[name] is not None:
                    dev_step[name] += sites * dv[name]
                else:
                    dev_step[name] = None
            if dv["fwd"] and dv["bwd"]:
                print(f"  kernel bandwidth: fwd {2 * nbytes / dv['fwd'] / 1e6:.0f}"
                      f" GB/s, bwd {3 * nbytes / dv['bwd'] / 1e6:.0f} GB/s "
                      "(ideal bytes over device time); bwd device "
                      f"{dv['bwd'] * 1e3:.2f} us against its bound "
                      f"{bound(3 * nbytes + 2 * small, 0)[0] * 1e3:.2f} us",
                      flush=True)
            del x, a, k, g, ins, refs, out, ref
    # the backward's launches, from the library's own counts: one call at
    # each site of the adapt batch
    calls = []
    for h, w, c in TAM_SITES:
        shape = (2, 16, h, w, c)
        x, g = (torch.randn(*shape, device=dev, generator=gen)
                for _ in range(2))
        a = torch.sigmoid(torch.randn(2, 16, c, device=dev, generator=gen))
        k = torch.softmax(torch.randn(2, c, 3, device=dev, generator=gen), -1)
        calls.append((g, x, a, k))
    names = launches_of(lambda: [tam_bwd_cuda(*args) for args in calls])
    per_kernel = [sum(v for key, v in names.items() if kern in key)
                  for kern in ("tam_bwd_kernel", "tam_bwd_reduce_kernel")]
    if per_kernel != [len(calls)] * 2 or sum(names.values()) != 2 * len(calls):
        raise AssertionError(f"tam bwd: launches {names} over one call at "
                             f"each of {len(calls)} sites, expected "
                             "tam_bwd_kernel and tam_bwd_reduce_kernel once "
                             "a call")
    print(f"tam bwd: 2 launches a call at each of the {len(calls)} sites "
          "(tam_bwd_kernel, tam_bwd_reduce_kernel; the library's counts)",
          flush=True)
    del calls
    for label, d in (("event", per_step), ("device", dev_step)):
        if None in d.values():
            print(f"tam per adapt step, {label} ms: not measured", flush=True)
            continue
        print(f"tam per adapt step (16 sites, n=2, t=16), {label} ms: fwd "
              f"{d['fwd']:.3f} (plain {d['plain_fwd']:.3f}), bwd "
              f"{d['bwd']:.3f} (plain {d['plain_bwd']:.3f})", flush=True)
    rows = []
    for d, line in (("fwd", 77), ("bwd", 92)):
        ms, by = bound(*need[d])
        rows.append({
            "name": f"tam_{d}", "route": "cuda",
            "source": "vitta_tpu_torch/csrc/tam.cu",
            "replaces": f"vitta_tpu/ops/pallas_tam.py:{line}",
            "max_abs_err": err[d], "ms": per_step[d],
            "plain_ms": per_step[f"plain_{d}"], "bound_ms": ms,
            "bound_by": by,
            "library_ms": None,      # no one PyTorch call computes the TAM
            "device_ms": dev_step[d],
            "plain_device_ms": dev_step[f"plain_{d}"]})
    return rows


def _report(what, err, times):
    """One line for one shape: ``times`` is {label: (event ms, device ms)}."""
    parts = [f"{k} {ev:.4f} (device {fmt(dv)})" for k, (ev, dv) in times.items()]
    print(f"{what}: max abs err {err:.2e} | event ms: " + ", ".join(parts),
          flush=True)


def phase_swin_kernels(dev):
    """The four Video Swin forward kernels against their plain versions at
    every Swin-B stage shape, for 1 and 2 clips, then the four backward
    kernels for 2 clips; returns their JSON rows, whose times are sums
    over the sites of one forward or backward pass of 2 clips (the
    source-statistics batch and the adapt batch)."""
    import torch.nn.functional as F
    from vitta_tpu_torch.models.swin import relative_position_index
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops import cuda_bias as cb
    from vitta_tpu_torch.ops import cuda_ln as cl
    from vitta_tpu_torch.ops import cuda_mlp as cm
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    wd, wh, ww = SWIN_WINDOW
    hw, n_tok = wh * ww, wd * wh * ww
    a_dim = 2 * wd - 1

    # A: LayerNorm forward
    ln = Totals()
    for (tokens, c), sites in SWIN_LN_SITES.items():
        for clips in (1, 2):
            x = randn(clips * tokens, c, scale=2.0) + 0.5
            g, b = randn(c), randn(c)
            want = cl.layer_norm_reference(x, g, b, 1e-5)
            err = check_close(f"ln {tuple(x.shape)}",
                              cl.ln_fwd_cuda(x, g, b, 1e-5), want, LN_TOL)
            ln.err = max(ln.err, err)
            t = {"kernel": measure(lambda: cl.ln_fwd_cuda(x, g, b, 1e-5)),
                 "plain": measure(lambda: cl.layer_norm_reference(x, g, b, 1e-5)),
                 "F.layer_norm": measure(lambda: F.layer_norm(x, (c,), g, b, 1e-5))}
            _report(f"ln rows={clips * tokens} C={c}", err, t)
            if clips == 2:
                ln.add(sites, ms=t["kernel"][0], device_ms=t["kernel"][1],
                       plain_ms=t["plain"][0], plain_device_ms=t["plain"][1],
                       library_ms=t["F.layer_norm"][0],
                       library_device_ms=t["F.layer_norm"][1],
                       bytes=(2 * x.numel() + 2 * c) * 4, flops=8 * x.numel())
            del x, want

    # B: bias expansion; the library call is the reference's gather
    bias = Totals()
    rpi = torch.from_numpy(relative_position_index(SWIN_WINDOW).copy()).to(
        dev).reshape(-1)
    for c, nh, _tokens, _nw, depth in SWIN_STAGES:
        table = randn(a_dim * (2 * wh - 1) * (2 * ww - 1), nh)
        v = cb.compact_bias(table, SWIN_WINDOW)
        got = cb.expand_bias_cuda(v, wd)
        gather = lambda: table[rpi].reshape(n_tok, n_tok, nh).permute(
            2, 0, 1).contiguous()
        if not (torch.equal(got, cb.expand_bias_reference(v, wd))
                and torch.equal(got, gather())):
            raise AssertionError(f"bias expansion nh={nh}: the kernel, the "
                                 "plain version and the gather differ")
        t = {"kernel": measure(lambda: cb.expand_bias_cuda(v, wd)),
             "plain": measure(lambda: cb.expand_bias_reference(v, wd)),
             "gather": measure(gather)}
        _report(f"bias nh={nh} -> ({nh},{n_tok},{n_tok}), bit-exact", 0.0, t)
        moved = (v.numel() + got.numel()) * 4
        if t["kernel"][1]:
            print(f"  bias expansion nh={nh}: device {t['kernel'][1] * 1e3:.2f}"
                  f" us, {moved / t['kernel'][1] / 1e6:.0f} GB/s, bound "
                  f"{bound(moved, 0)[0] * 1e3:.2f} us ({depth} launches a "
                  "pass)", flush=True)
        bias.add(depth, ms=t["kernel"][0], device_ms=t["kernel"][1],
                 plain_ms=t["plain"][0], plain_device_ms=t["plain"][1],
                 library_ms=t["gather"][0], library_device_ms=t["gather"][1],
                 bytes=(v.numel() + got.numel()) * 4, flops=0)
        del got

    # C: packed window attention; the library call is
    # scaled_dot_product_attention on the unpacked views with
    # attn_mask = bias + mask, made outside the timed call
    attn = Totals()
    for c, nh, tokens, nw, depth in SWIN_STAGES:
        hd = c // nh
        scale = hd ** -0.5
        vc = randn(nh, a_dim, hw, hw)
        dense = cb.expand_bias_reference(vc, wd)
        mask = None
        if nw > 1:      # the last stage's window covers its input: no shift
            mask = torch.where(
                torch.rand(nw, n_tok, n_tok, device=dev, generator=gen) < 0.3,
                -100.0, 0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
        for clips in (1, 2):
            b_ = clips * tokens // n_tok
            qkv = randn(b_, n_tok, 3 * c)
            for m in ((None, mask) if mask is not None else (None,)):
                want, want_ms = ca.packed_attention_reference(
                    qkv, dense, m, scale, nh, save_ms=True)
                err = 0.0
                for form, bias_t in (("dense", dense), ("compact", vc)):
                    got, ms_ = ca.attn_packed_fwd_cuda(qkv, bias_t, m, scale,
                                                       nh, save_ms=True)
                    what = (f"attention B_={b_} nh={nh} mask="
                            f"{m is not None} {form}")
                    err = max(err, check_close(what, got, want, ATTN_TOL),
                              check_close(what + " row max/sum", ms_, want_ms,
                                          ATTN_TOL))
                    del got, ms_
                attn.err = max(attn.err, err)
                q5 = qkv.reshape(b_, n_tok, 3, nh, hd).permute(2, 0, 3, 1, 4)
                am = dense[None] if m is None else (
                    dense[None, None] + m[None, :, None]).expand(
                        b_ // nw, nw, nh, n_tok, n_tok).reshape(
                            b_, nh, n_tok, n_tok)
                sdpa = lambda: F.scaled_dot_product_attention(
                    q5[0], q5[1], q5[2], attn_mask=am, scale=scale)
                check_close("scaled_dot_product_attention",
                            sdpa().permute(0, 2, 1, 3).reshape(b_, n_tok, c),
                            want, 1e-3)
                t = {"kernel": measure(lambda: ca.attn_packed_fwd_cuda(
                         qkv, dense, m, scale, nh)),
                     "kernel compact": measure(lambda: ca.attn_packed_fwd_cuda(
                         qkv, vc, m, scale, nh)),
                     "plain": measure(lambda: ca.packed_attention_reference(
                         qkv, dense, m, scale, nh)),
                     "sdpa": measure(sdpa)}
                _report(f"attention B_={b_} N={n_tok} nh={nh} hd={hd} mask="
                        f"{m is not None}", err, t)
                if clips == 2:
                    # shifted blocks are every second one where there is a mask
                    sites = depth // 2 if mask is not None else depth
                    nbytes = (qkv.numel() + b_ * n_tok * c + dense.numel()
                              + (0 if m is None else m.numel())) * 4
                    flops = b_ * nh * n_tok * n_tok * (4 * hd + 6)
                    attn.add(sites, ms=t["kernel"][0], device_ms=t["kernel"][1],
                             plain_ms=t["plain"][0],
                             plain_device_ms=t["plain"][1],
                             library_ms=t["sdpa"][0],
                             library_device_ms=t["sdpa"][1],
                             bytes=nbytes, flops=flops,
                             tc_flops=b_ * nh * n_tok * n_tok * 4 * hd)
                del want, want_ms, am
            del qkv

    # D: fused LayerNorm-MLP; no one PyTorch call computes it
    mlp = Totals()
    for c, _nh, tokens, _nw, depth in SWIN_STAGES:
        f = 4 * c
        g, bt = 1 + 0.1 * randn(c), 0.1 * randn(c)
        w1, b1 = randn(f, c, scale=c ** -0.5), 0.1 * randn(f)
        w2, b2 = randn(c, f, scale=f ** -0.5), 0.1 * randn(c)
        for clips in (1, 2):
            m_rows = clips * tokens
            x = randn(m_rows, c, scale=1.5)
            args = (x, g, bt, w1, b1, w2, b2, 1e-5)
            got = cm.ln_mlp_fwd_cuda(*args, save_residuals=True)
            want = cm.ln_mlp_reference(*args, save_residuals=True)
            err = max(check_close(f"ln_mlp M={m_rows} C={c} {nm}", p, q,
                                  MLP_TOL)
                      for nm, p, q in zip(("o", "y", "a", "s"), got, want))
            mlp.err = max(mlp.err, err)
            del got, want
            t = {"kernel": measure(lambda: cm.ln_mlp_fwd_cuda(*args)),
                 "plain": measure(lambda: cm.ln_mlp_reference(*args))}
            flops = 4 * m_rows * c * f + 10 * m_rows * f + 8 * m_rows * c
            _report(f"ln_mlp M={m_rows} C={c} F={f}", err, t)
            if t["kernel"][1]:
                print(f"  kernel rate: {flops / t['kernel'][1] / 1e9:.1f} "
                      "TFLOP/s float32 (operations over device time)",
                      flush=True)
            if clips == 2:
                mlp.add(depth, ms=t["kernel"][0], device_ms=t["kernel"][1],
                        plain_ms=t["plain"][0], plain_device_ms=t["plain"][1],
                        bytes=(3 * x.numel() + 2 * c * f + f + 3 * c) * 4,
                        flops=flops, tc_flops=4 * m_rows * c * f)
            del x, args


    # ------------------------------------------------------------------
    # the backward kernels, at the adapt batch of 2 clips
    # E: LayerNorm backward; the library call is F.layer_norm's backward.
    # Swin-B's sites make the row; Swin-T's (widths 96 to 1536, none of
    # them 128 * 2^k) are held and timed too.  Each call: the kernel's own
    # plan, two launches, the same bits twice
    ln_b = Totals()
    for model, ln_sites in (("swin_b", SWIN_LN_SITES),
                            ("swin_t", SWIN_T_LN_SITES)):
        dev_sum, bound_sum = 0.0, 0.0      # ms a pass
        for (tokens, c), sites in ln_sites.items():
            rows = 2 * tokens
            x = randn(rows, c, scale=2.0) + 0.5
            g, b, dy = randn(c), randn(c), randn(rows, c)
            want = cl.layer_norm_backward_reference(x, g, dy, 1e-5)
            got = cl.ln_bwd_cuda(x, g, dy, 1e-5)
            what = f"ln bwd {model} rows={rows} C={c}"
            err = max(check_scaled(f"{what} {nm}", p, q, LN_BWD_TOL)
                      for nm, p, q in zip(("dx", "dgamma", "dbeta"), got,
                                          want))
            ln_b.err = max(ln_b.err, err)
            again = cl.ln_bwd_cuda(x, g, dy, 1e-5)
            if not all(torch.equal(p, q) for p, q in zip(got, again)):
                raise AssertionError(f"{what}: two runs differ")
            vec = cl.bwd_vec(c, x, g, dy, got[0])
            plan = cl.ln_bwd_plan_cuda(rows, c, vec)
            if plan != cl.ln_bwd_plan(rows, c, vec):
                raise AssertionError(f"{what}: the kernel's plan {plan} is "
                                     "not ln_bwd_plan's")
            names = launches_of(lambda: cl.ln_bwd_cuda(x, g, dy, 1e-5))
            if (sum(names.values()) != 2
                    or sum(n for k, n in names.items()
                           if k.startswith("ln_bwd_kernel")) != 1
                    or names.get("reduce_partials_kernel") != 1):
                raise AssertionError(f"{what}: launches {names}, expected "
                                     "ln_bwd_kernel and reduce_partials once")
            del got, want, again
            leaves = [v.clone().requires_grad_() for v in (x, g, b)]
            y_lib = F.layer_norm(leaves[0], (c,), leaves[1], leaves[2], 1e-5)
            t = {"kernel": measure(lambda: cl.ln_bwd_cuda(x, g, dy, 1e-5)),
                 "plain": measure(lambda: cl.layer_norm_backward_reference(
                     x, g, dy, 1e-5)),
                 "F.layer_norm backward": measure(lambda: torch.autograd.grad(
                     y_lib, leaves, dy, retain_graph=True))}
            _report(f"{what}, 2 launches, two runs bit-equal", err, t)
            nbytes = (3 * x.numel() + 3 * c) * 4
            bound_ms = bound(nbytes, 0)[0]
            dev_ms = t["kernel"][1]
            bound_sum += sites * bound_ms
            dev_sum = None if dev_ms is None or dev_sum is None \
                else dev_sum + sites * dev_ms
            if dev_ms:
                print(f"  {what}: device {dev_ms * 1e3:.2f} us, "
                      f"{nbytes / dev_ms / 1e6:.0f} GB/s, bound "
                      f"{bound_ms * 1e3:.2f} us ({sites} calls a pass; "
                      f"{plan['blocks']} blocks of {plan['rows_per_block']} "
                      f"rows, {plan['wpr']} warp(s) a row, {plan['units']} "
                      f"{'float4' if vec else 'float'} units a lane, "
                      f"{plan['batch']} row(s) at once)", flush=True)
            if model == "swin_b":
                ln_b.add(sites, ms=t["kernel"][0], device_ms=dev_ms,
                         plain_ms=t["plain"][0],
                         plain_device_ms=t["plain"][1],
                         library_ms=t["F.layer_norm backward"][0],
                         library_device_ms=t["F.layer_norm backward"][1],
                         bytes=nbytes, flops=14 * x.numel())
            del x, dy, leaves, y_lib
        print(f"ln bwd per {model} pass of 2 clips: device ms "
              f"{fmt(dev_sum)}, bound {bound_sum:.4f}", flush=True)

    # F: bias collapse; the library call is one index_add_ into a zeroed
    # dV over a flat map from dB to dV, what autograd makes of the
    # expansion's gather (index_add_ adds with atomics, in no fixed order)
    coll = Totals()
    for c, nh, _tokens, _nw, depth in SWIN_STAGES:
        db = randn(nh, n_tok, n_tok)
        got = cb.collapse_bias_cuda(db, wd)
        what = f"bias collapse nh={nh}"
        if not torch.equal(got, cb.collapse_bias_reference(db, wd)):
            raise AssertionError(f"{what}: the kernel and the plain version "
                                 "differ")
        names = launches_of(lambda: cb.collapse_bias_cuda(db, wd))
        if (sum(names.values()) != 1
                or names.get("collapse_bias_staged<true>") != 1):
            raise AssertionError(f"{what}: launches {names}, expected "
                                 "collapse_bias_staged<true> once")
        r = torch.arange(n_tok, device=dev)
        d1, i = r // hw, r % hw
        a_of = d1[:, None] - d1[None, :] + wd - 1          # (N, N)
        flat = (((torch.arange(nh, device=dev)[:, None, None] * a_dim
                  + a_of) * hw + i[:, None]) * hw + i[None, :]).reshape(-1)
        zeros = torch.zeros(got.numel(), device=dev)
        lib_call = lambda: zeros.index_add(0, flat, db.reshape(-1))
        check_close(f"{what} index_add", lib_call().view_as(got), got, 1e-5)
        t = {"kernel": measure(lambda: cb.collapse_bias_cuda(db, wd)),
             "plain": measure(lambda: cb.collapse_bias_reference(db, wd)),
             "index_add": measure(lib_call)}
        _report(f"{what} ({nh},{n_tok},{n_tok}) -> ({nh},{a_dim},{hw},{hw}), "
                "bit-exact, 1 launch", 0.0, t)
        nbytes = (db.numel() + got.numel()) * 4
        if t["kernel"][1]:
            print(f"  {what}: device {t['kernel'][1] * 1e3:.2f} us, "
                  f"{nbytes / t['kernel'][1] / 1e6:.0f} GB/s, bound "
                  f"{bound(nbytes, 0)[0] * 1e3:.2f} us ({depth} launches a "
                  "pass)", flush=True)
        coll.add(depth, ms=t["kernel"][0], device_ms=t["kernel"][1],
                 plain_ms=t["plain"][0], plain_device_ms=t["plain"][1],
                 library_ms=t["index_add"][0],
                 library_device_ms=t["index_add"][1],
                 bytes=nbytes, flops=db.numel())
        del db, got, flat, zeros

    # G: attention backward; the library call is
    # scaled_dot_product_attention's backward for dq, dk, dv (it has no
    # bias gradient).  One clip too, values and launches only: Swin-B's
    # last two stages then have fewer problems than the card has SMs, and
    # blocks share a problem (at 2 clips the last stage already does)
    attn_b = Totals()
    for c, nh, tokens, nw, depth in SWIN_STAGES:
        hd = c // nh
        scale = hd ** -0.5
        vc = randn(nh, a_dim, hw, hw)
        dense = cb.expand_bias_reference(vc, wd)
        mask = None
        if nw > 1:
            mask = torch.where(
                torch.rand(nw, n_tok, n_tok, device=dev, generator=gen) < 0.3,
                -100.0, 0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
        for clips in (2, 1):
            b_ = clips * tokens // n_tok
            split = ca.bwd_split(b_, nh, dev)
            qkv, g = randn(b_, n_tok, 3 * c), randn(b_, n_tok, c)
            for m in ((None, mask) if mask is not None else (None,)):
                _out, ms_ = ca.attn_packed_fwd_cuda(qkv, dense, m, scale, nh,
                                                    save_ms=True)
                want = ca.packed_attention_backward_reference(
                    qkv, dense, m, ms_, g, scale, nh)
                want_c = cb.collapse_bias_reference(want[1], wd)
                what = (f"attention bwd B_={b_} N={n_tok} nh={nh} hd={hd} "
                        f"mask={m is not None}")
                err = 0.0
                for form, bias_t, want_db in (("dense", dense, want[1]),
                                              ("compact", vc, want_c)):
                    got = ca.attn_packed_bwd_cuda(qkv, bias_t, m, ms_, g,
                                                  scale, nh)
                    for i, nm in enumerate(("dq", "dk", "dv")):
                        err = max(err, check_scaled(
                            f"{what} {form} {nm}",
                            got[0][..., i * c:(i + 1) * c],
                            want[0][..., i * c:(i + 1) * c], ATTN_BWD_TOL))
                    err = max(err, check_scaled(f"{what} {form} dbias",
                                                got[1], want_db, ATTN_BWD_TOL))
                    again = ca.attn_packed_bwd_cuda(qkv, bias_t, m, ms_, g,
                                                    scale, nh)
                    if not (torch.equal(again[0], got[0])
                            and torch.equal(again[1], got[1])):
                        raise AssertionError(f"{what} {form}: two runs differ")
                    del got, again
                attn_b.err = max(attn_b.err, err)
                del want, want_c
                launches = check_attn_bwd_launches(
                    what, lambda: ca.attn_packed_bwd_cuda(
                        qkv, dense, m, ms_, g, scale, nh), split)
                what += f", {split} block(s) a problem, {launches} launches"
                if clips == 1:
                    print(f"{what}: max abs err {err:.2e}, two runs "
                          "bit-equal", flush=True)
                    del ms_
                    continue
                q5 = qkv.reshape(b_, n_tok, 3, nh, hd).permute(2, 0, 3, 1, 4)
                leaves = [q5[i].detach().requires_grad_() for i in range(3)]
                am = dense[None] if m is None else (
                    dense[None, None] + m[None, :, None]).expand(
                        b_ // nw, nw, nh, n_tok, n_tok).reshape(
                            b_, nh, n_tok, n_tok)
                o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=am,
                                                       scale=scale)
                g4 = g.reshape(b_, n_tok, nh, hd).permute(0, 2, 1, 3)
                t = {"kernel": measure(lambda: ca.attn_packed_bwd_cuda(
                         qkv, dense, m, ms_, g, scale, nh)),
                     "kernel compact": measure(lambda: ca.attn_packed_bwd_cuda(
                         qkv, vc, m, ms_, g, scale, nh)),
                     "plain": measure(
                         lambda: ca.packed_attention_backward_reference(
                             qkv, dense, m, ms_, g, scale, nh)),
                     "sdpa backward": measure(lambda: torch.autograd.grad(
                         o_lib, leaves, g4, retain_graph=True))}
                _report(what, err, t)
                sites = depth // 2 if mask is not None else depth
                nbytes = (2 * qkv.numel() + g.numel() + ms_.numel()
                          + 2 * dense.numel()
                          + (0 if m is None else m.numel())) * 4
                pairs = b_ * nh * n_tok * n_tok
                attn_b.add(sites, ms=t["kernel"][0], device_ms=t["kernel"][1],
                           plain_ms=t["plain"][0],
                           plain_device_ms=t["plain"][1],
                           library_ms=t["sdpa backward"][0],
                           library_device_ms=t["sdpa backward"][1],
                           bytes=nbytes, flops=pairs * (10 * hd + 12),
                           tc_flops=pairs * 10 * hd)
                del leaves, am, o_lib, ms_
            del qkv, g

    # H: LayerNorm-MLP backward; no one PyTorch call computes it.  The
    # tap's cotangent on y exists at the chosen blocks, stages 3 and 4
    mlp_b = Totals()
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for stage, (c, _nh, tokens, _nw, depth) in enumerate(SWIN_STAGES):
        f = 4 * c
        gm, bt = 1 + 0.1 * randn(c), 0.1 * randn(c)
        w1, b1 = randn(f, c, scale=c ** -0.5), 0.1 * randn(f)
        w2, b2 = randn(c, f, scale=f ** -0.5), 0.1 * randn(c)
        m_rows = 2 * tokens
        x = randn(m_rows, c, scale=1.5)
        _o, y, a, s_ = cm.ln_mlp_fwd_cuda(x, gm, bt, w1, b1, w2, b2, 1e-5,
                                          save_residuals=True)
        go, gy_full = randn(m_rows, c), randn(m_rows, c)
        for gy in (gy_full, None):
            args = (x, y, a, s_, go, gy, gm, w1, w2, 1e-5)
            got = cm.ln_mlp_bwd_cuda(*args)
            want = cm.ln_mlp_backward_reference(*args)
            err = max(check_scaled(f"ln_mlp bwd M={m_rows} C={c} gy="
                                   f"{gy is not None} {nm}", p, q, MLP_BWD_TOL)
                      for nm, p, q in zip(names, got, want))
            mlp_b.err = max(mlp_b.err, err)
            del got, want
            t = {"kernel": measure(lambda: cm.ln_mlp_bwd_cuda(*args)),
                 "plain": measure(lambda: cm.ln_mlp_backward_reference(*args))}
            flops = 8 * m_rows * c * f + 4 * m_rows * f + 20 * m_rows * c
            _report(f"ln_mlp bwd M={m_rows} C={c} F={f} gy={gy is not None}",
                    err, t)
            if t["kernel"][1]:
                print(f"  kernel rate: {flops / t['kernel'][1] / 1e9:.1f} "
                      "TFLOP/s float32 (operations over device time)",
                      flush=True)
            if (gy is not None) == (stage >= 2):
                nbytes = ((5 if gy is not None else 4) * m_rows * c
                          + 2 * m_rows * f + 4 * c * f + f + 4 * c) * 4
                mlp_b.add(depth, ms=t["kernel"][0], device_ms=t["kernel"][1],
                          plain_ms=t["plain"][0],
                          plain_device_ms=t["plain"][1], bytes=nbytes,
                          flops=flops, tc_flops=8 * m_rows * c * f)
        del x, y, a, s_, go, gy_full, args

    src, ops = "vitta_tpu_torch/csrc", "vitta_tpu/ops"
    rows = [ln.row("ln_fwd", f"{src}/ln.cu", f"{ops}/pallas_ln.py:47"),
            bias.row("bias_expand", f"{src}/bias.cu",
                     f"{ops}/pallas_bias.py:59"),
            attn.row("attn_packed_fwd", f"{src}/attention.cu",
                     f"{ops}/pallas_attention.py:448"),
            mlp.row("ln_mlp_fwd", f"{src}/mlp.cu", f"{ops}/pallas_mlp.py:303",
                    has_library=False),
            ln_b.row("ln_bwd", f"{src}/ln.cu", f"{ops}/pallas_ln.py:55"),
            coll.row("bias_collapse", f"{src}/bias.cu",
                     f"{ops}/pallas_bias.py:67"),
            attn_b.row("attn_packed_bwd", f"{src}/attention.cu",
                       f"{ops}/pallas_attention.py:517"),
            mlp_b.row("ln_mlp_bwd", f"{src}/mlp.cu", f"{ops}/pallas_mlp.py:322",
                      has_library=False)]
    fwd, bwd = swin_launches(None)
    per_pass = {**fwd, **bwd}
    for r in rows:
        print(f"{r['name']} per Swin-B pass of 2 clips "
              f"({per_pass[r['name']]} launches): event ms "
              f"{r['ms']:.3f}, device ms {fmt(r['device_ms'])}, plain "
              f"{r['plain_ms']:.3f} (device {fmt(r['plain_device_ms'])}), "
              f"library {fmt(r['library_ms'])} (device "
              f"{fmt(r['library_device_ms'])}), bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}{_floor(r)}", flush=True)
    return rows


def _floor(row) -> str:
    """The split-TF32 floor of a row whose products run on the tensor
    cores, to print beside its float32 bound."""
    if "tf32x3_floor_ms" not in row:
        return ""
    return (f"; split-TF32 floor {row['tf32x3_floor_ms']:.4f} (3 tf32 "
            "products of its matrix products at 495 TFLOP/s)")


def phase_swin_proj_kernels(dev):
    """The projection-fused window attention kernels, with and without the
    LayerNorm prologue, against their plain versions at every Swin-B stage
    shape: forward for 1 and 2 clips, backward for 2 clips, with and
    without mask, the LayerNorm form with and without a cotangent on y.
    Returns their JSON rows, whose times are sums over the 24 sites of one
    forward or backward pass of 2 clips.  The library call of ``attn_proj``
    is ``F.multi_head_attention_forward`` on the token-major (N, B_, C) copy
    of x, with the packed in-projection, attn_mask = bias + mask of shape
    (B_*nh, N, N) made outside the timed call and ``need_weights=False``,
    and its backward under autograd for dx and the four projection
    gradients (it gives no bias gradient); the LayerNorm form returns y as
    well, which no one call computes.  Beside each op the composition it
    replaces is timed too (LayerNorm kernel, ``F.linear``, packed attention
    kernel, ``F.linear``, and their backward under autograd): that one
    runs the port's own kernels, so it is no library time."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops import cuda_attention_proj as cp
    from vitta_tpu_torch.ops import cuda_bias as cb
    from vitta_tpu_torch.ops import cuda_ln as cl
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def quick(fn, grad=False):
        return measure(fn, reps=5, dev_reps=3, grad=grad)

    wd, wh, ww = SWIN_WINDOW
    hw, n_tok = wh * ww, wd * wh * ww
    eps = 1e-5
    tot = {k: Totals() for k in ("proj_fwd", "proj_bwd", "ln_proj_fwd",
                                 "ln_proj_bwd")}
    comp = dict.fromkeys(tot, 0.0)       # the composition's device ms
    per_call = {"proj_bwd": set(), "ln_proj_bwd": set()}  # launches a call

    def add_composition(key, sites, device_ms):
        comp[key] = None if (device_ms is None or comp[key] is None) \
            else comp[key] + sites * device_ms

    bwd_names = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
    ln_bwd_names = ("dx", "dgamma", "dbeta") + bwd_names[1:]
    for stage, (c, nh, tokens, nw, depth) in enumerate(SWIN_STAGES):
        hd = c // nh
        scale = hd ** -0.5
        gm, bt = 1 + 0.1 * randn(c), 0.1 * randn(c)
        wqkv, bqkv = randn(3 * c, c, scale=c ** -0.5), 0.1 * randn(3 * c)
        wproj, bproj = randn(c, c, scale=c ** -0.5), 0.1 * randn(c)
        dense = cb.expand_bias_reference(
            randn(nh, 2 * wd - 1, hw, hw), wd)
        mask = None
        if nw > 1:
            mask = torch.where(
                torch.rand(nw, n_tok, n_tok, device=dev, generator=gen) < 0.3,
                -100.0, 0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
        w = (wqkv, bqkv, wproj, bproj)
        for clips in (1, 2):
            b_ = clips * tokens // n_tok
            m_rows = b_ * n_tok
            x = randn(b_, n_tok, c, scale=1.5) + 0.3
            g = randn(b_, n_tok, c)
            gy_full = randn(b_, n_tok, c)
            for m in ((None, mask) if mask is not None else (None,)):
                tag = (f"B_={b_} N={n_tok} C={c} nh={nh} mask="
                       f"{m is not None}")
                sites = depth // 2 if mask is not None else depth
                attn_flops = b_ * nh * n_tok * n_tok * (4 * hd + 6)
                small = (4 * c * c + 4 * c + dense.numel()
                         + (0 if m is None else m.numel()))
                # forward, both forms
                got = cp.attn_proj_fwd(x, *w, dense, m, scale, nh, True)
                want = cp.proj_attention_reference(x, *w, dense, m, scale, nh,
                                                   True)
                err = max(check_close(f"attn_proj fwd {tag} {nm}", p_, q_,
                                      PROJ_TOL)
                          for nm, p_, q_ in zip(("out", "qkv", "o_att", "ms"),
                                                got, want))
                tot["proj_fwd"].err = max(tot["proj_fwd"].err, err)
                got_ln = cp.attn_ln_proj_fwd(x, gm, bt, eps, *w, dense, m,
                                             scale, nh, True)
                want_ln = cp.ln_proj_attention_reference(
                    x, gm, bt, eps, *w, dense, m, scale, nh, True)
                err_ln = max(check_close(f"attn_ln_proj fwd {tag} {nm}", p_,
                                         q_, PROJ_TOL)
                             for nm, p_, q_ in zip(
                                 ("out", "y", "qkv", "o_att", "ms"), got_ln,
                                 want_ln))
                tot["ln_proj_fwd"].err = max(tot["ln_proj_fwd"].err, err_ln)
                # what each forward keeps, which its backward reads
                _o, qkv_, o_att, ms_ = got
                _o, y_ln, qkv_ln, o_att_ln, ms_ln = got_ln
                want_out = want[0]
                del got, want, got_ln, want_ln, _o

                def composition(xin, with_ln):
                    y = cl.layer_norm(xin, gm, bt, eps) if with_ln else xin
                    qkv = F.linear(y, wqkv, bqkv)
                    o = ca.window_attention_packed(qkv, dense, m, scale, nh)
                    return F.linear(o, wproj, bproj), y

                if clips == 1:      # the eval batch: held to plain, not timed
                    print(f"attn_proj / attn_ln_proj fwd {tag}: max abs err "
                          f"{max(err, err_ln):.2e}", flush=True)
                    continue
                times = {"proj": quick(lambda: cp.attn_proj_fwd(
                             x, *w, dense, m, scale, nh)),
                         "ln_proj": quick(lambda: cp.attn_ln_proj_fwd(
                             x, gm, bt, eps, *w, dense, m, scale, nh))}
                am = (dense[None] if m is None else
                      dense[None, None] + m[None, :, None]).expand(
                          b_ // nw, nw, nh, n_tok, n_tok).reshape(
                              b_ * nh, n_tok, n_tok)
                x_t = x.transpose(0, 1).contiguous()

                def mha(xin, wq, bq, wp_, bp_):
                    return F.multi_head_attention_forward(
                        xin, xin, xin, c, nh, wq, bq, None, None, False,
                        0.0, wp_, bp_, training=False, need_weights=False,
                        attn_mask=am)[0]

                check_close(f"multi_head_attention_forward {tag}",
                            mha(x_t, *w).transpose(0, 1), want_out, 1e-3)
                times.update({
                    "proj library": quick(lambda: mha(x_t, *w)),
                    "proj plain": quick(lambda: cp.proj_attention_reference(
                        x, *w, dense, m, scale, nh)),
                    "ln_proj plain": quick(
                        lambda: cp.ln_proj_attention_reference(
                            x, gm, bt, eps, *w, dense, m, scale, nh)),
                    "proj composition": quick(
                        lambda: composition(x, False)),
                    "ln_proj composition": quick(
                        lambda: composition(x, True))})
                _report(f"attn_proj / attn_ln_proj fwd {tag}",
                        max(err, err_ln), times)
                flops = 8 * m_rows * c * c + attn_flops
                tc_fwd = 8 * m_rows * c * c + b_ * nh * n_tok * n_tok * 4 * hd
                tot["proj_fwd"].add(
                    sites, library_ms=times["proj library"][0],
                    library_device_ms=times["proj library"][1])
                for key, form, extra in (("proj_fwd", "proj", 0),
                                         ("ln_proj_fwd", "ln_proj", 1)):
                    tot[key].add(
                        sites, ms=times[form][0], device_ms=times[form][1],
                        plain_ms=times[f"{form} plain"][0],
                        plain_device_ms=times[f"{form} plain"][1],
                        bytes=((2 + extra) * m_rows * c + small
                               + 2 * extra * c) * 4,
                        flops=flops + extra * 8 * m_rows * c, tc_flops=tc_fwd)
                    add_composition(key, sites,
                                    times[f"{form} composition"][1])

                # backward, both forms, at the adapt batch
                bflops = (16 * m_rows * c * c
                          + b_ * nh * n_tok * n_tok * (10 * hd + 12))
                tc_bwd = 16 * m_rows * c * c + b_ * nh * n_tok * n_tok * 10 * hd
                pargs = (x, qkv_, wqkv, wproj, dense, m, o_att, ms_, g,
                         scale, nh)
                got = cp.attn_proj_bwd(*pargs)
                want = cp.proj_attention_backward_reference(*pargs)
                err = max(check_scaled(f"attn_proj bwd {tag} {nm}", p_, q_,
                                       PROJ_BWD_TOL)
                          for nm, p_, q_ in zip(bwd_names, got, want))
                again = cp.attn_proj_bwd(*pargs)
                if not all(torch.equal(a, b) for a, b in zip(again, got)):
                    raise AssertionError(f"attn_proj bwd {tag}: two runs "
                                         "differ")
                launches = {"proj": check_proj_bwd_launches(
                    f"attn_proj bwd {tag}", lambda: cp.attn_proj_bwd(*pargs),
                    False)}
                tot["proj_bwd"].err = max(tot["proj_bwd"].err, err)
                del got, want, again
                leaves = [v.detach().clone().requires_grad_()
                          for v in (x, wqkv, bqkv, wproj, bproj, dense)]

                def comp_graph(with_ln):
                    xin, wq, bq, wp_, bp_, bias_ = leaves
                    y = cl.layer_norm(xin, gm_l, bt_l, eps) if with_ln else xin
                    o = ca.window_attention_packed(F.linear(y, wq, bq), bias_,
                                                   m, scale, nh)
                    return F.linear(o, wp_, bp_), y

                gm_l = gm.detach().clone().requires_grad_()
                bt_l = bt.detach().clone().requires_grad_()
                lib_leaves = [v.detach().clone().requires_grad_()
                              for v in (x_t, wqkv, bqkv, wproj, bproj)]
                g_t = g.transpose(0, 1).contiguous()
                with torch.enable_grad():
                    out_c, _ = comp_graph(False)
                    out_lib = mha(*lib_leaves)
                times = {
                    "proj library": quick(lambda: torch.autograd.grad(
                        out_lib, lib_leaves, g_t, retain_graph=True),
                        grad=True),
                    "proj": quick(lambda: cp.attn_proj_bwd(*pargs)),
                    "proj plain": quick(
                        lambda: cp.proj_attention_backward_reference(*pargs)),
                    "proj composition": quick(lambda: torch.autograd.grad(
                        out_c, leaves, g, retain_graph=True), grad=True)}
                del out_c, out_lib, lib_leaves, g_t
                # x, qkv, o_att, g read, dx written
                nbytes = (7 * m_rows * c + ms_.numel() + 2 * small) * 4
                tot["proj_bwd"].add(
                    sites, ms=times["proj"][0], device_ms=times["proj"][1],
                    library_ms=times["proj library"][0],
                    library_device_ms=times["proj library"][1],
                    plain_ms=times["proj plain"][0],
                    plain_device_ms=times["proj plain"][1], bytes=nbytes,
                    flops=bflops, tc_flops=tc_bwd)
                add_composition("proj_bwd", sites,
                                times["proj composition"][1])
                for gy in (gy_full, None):
                    args = (x, y_ln, qkv_ln, gm, eps, wqkv, wproj, dense, m,
                            o_att_ln, ms_ln, g, gy, scale, nh)
                    got = cp.attn_ln_proj_bwd(*args)
                    want = cp.ln_proj_attention_backward_reference(*args)
                    what = f"attn_ln_proj bwd {tag} gy={gy is not None}"
                    e_ln = max(check_scaled(f"{what} {nm}", p_, q_,
                                            PROJ_BWD_TOL)
                               for nm, p_, q_ in zip(ln_bwd_names, got, want))
                    again = cp.attn_ln_proj_bwd(*args)
                    if not all(torch.equal(a, b) for a, b in zip(again, got)):
                        raise AssertionError(f"{what}: two runs differ")
                    launches[f"ln_proj gy={gy is not None}"] = \
                        check_proj_bwd_launches(
                            what, lambda: cp.attn_ln_proj_bwd(*args), True)
                    tot["ln_proj_bwd"].err = max(tot["ln_proj_bwd"].err, e_ln)
                    err = max(err, e_ln)
                    del got, want, again
                    with torch.enable_grad():
                        out_c, y_c = comp_graph(True)
                    outs, cots = ([out_c, y_c], [g, gy]) if gy is not None \
                        else ([out_c], [g])
                    lv = leaves + [gm_l, bt_l]
                    key = f"ln_proj gy={gy is not None}"
                    times[key] = quick(lambda: cp.attn_ln_proj_bwd(*args))
                    times[key + " plain"] = quick(
                        lambda: cp.ln_proj_attention_backward_reference(*args))
                    times[key + " composition"] = quick(
                        lambda: torch.autograd.grad(outs, lv, cots,
                                                    retain_graph=True),
                        grad=True)
                    del out_c, y_c, outs
                    # the tap's cotangent exists at the chosen blocks,
                    # stages 3 and 4
                    if (gy is not None) == (stage >= 2):
                        tot["ln_proj_bwd"].add(
                            sites, ms=times[key][0], device_ms=times[key][1],
                            plain_ms=times[key + " plain"][0],
                            plain_device_ms=times[key + " plain"][1],
                            bytes=nbytes + ((2 if gy is not None else 1)
                                            * m_rows * c + 4 * c) * 4,
                            flops=bflops + 20 * m_rows * c, tc_flops=tc_bwd)
                        add_composition("ln_proj_bwd", sites,
                                        times[key + " composition"][1])
                _report(f"attn_proj / attn_ln_proj bwd {tag}", err, times)
                print(f"attn_proj / attn_ln_proj bwd {tag}: launches per "
                      "call " + ", ".join(f"{k} {v}" for k, v in
                                          launches.items()), flush=True)
                for k, v in launches.items():
                    per_call["proj_bwd" if k == "proj" else
                             "ln_proj_bwd"].add(v)
                del leaves, o_att, ms_, o_att_ln, ms_ln, am, x_t, want_out
                del qkv_, y_ln, qkv_ln
            del x, g, gy_full

    src, ops = "vitta_tpu_torch/csrc/attention_proj.cu", \
        "vitta_tpu/ops/pallas_attention.py"
    rows = [tot["proj_fwd"].row("attn_proj_fwd", src, f"{ops}:724"),
            tot["proj_bwd"].row("attn_proj_bwd", src, f"{ops}:747"),
            tot["ln_proj_fwd"].row("attn_ln_proj_fwd", src, f"{ops}:945",
                                   False),
            tot["ln_proj_bwd"].row("attn_ln_proj_bwd", src, f"{ops}:967",
                                   False)]
    for r, key in zip(rows, ("proj_fwd", "proj_bwd", "ln_proj_fwd",
                             "ln_proj_bwd")):
        r["composition_device_ms"] = comp[key]
        if key in per_call:
            r["launches_per_call"] = sorted(per_call[key])
        print(f"{r['name']} per Swin-B pass of 2 clips (24 launches): event "
              f"ms {r['ms']:.3f}, device ms {fmt(r['device_ms'])}, plain "
              f"{r['plain_ms']:.3f} (device {fmt(r['plain_device_ms'])}), "
              + ("library none" if "ln_proj" in r["name"] else
                 f"library {r['library_ms']:.3f} (device "
                 f"{fmt(r['library_device_ms'])})")
              + f", the composition it replaces device "
              f"{fmt(comp[key])}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}{_floor(r)}"
              + (f"; launches per call {r['launches_per_call']}"
                 if key in per_call else ""), flush=True)
    return rows


def phase_unfused_kernels(dev):
    """The MLP kernels without the LayerNorm and the attention kernels per
    (head, window) against their plain versions, forward and backward, at
    every Swin-T and every Swin-B stage shape for 2 clips, the attention
    with and without mask and on q, k, v as views of a packed projection
    output, as the model hands them over; two runs of each backward must
    be bit-equal.  Returns their JSON rows, whose times are sums over the
    sites of one forward or backward pass of Swin-T on 2 clips: the MLP at
    the 4 blocks of stages 1 and 2 (widths 96 and 192, the ones the model
    sends to these kernels), the attention at all 12 blocks.  Timed beside
    the MLP is the composition ``F.linear``-``F.gelu``-``F.linear`` (which
    is its plain version) and that composition's backward under autograd;
    beside the attention ``scaled_dot_product_attention`` on the same
    views with attn_mask = bias + mask made outside the timed call, and its
    backward, which gives no bias gradient."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops import cuda_bias as cb
    from vitta_tpu_torch.ops import cuda_mlp as cm
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def quick(fn, grad=False):
        return measure(fn, reps=5, dev_reps=3, grad=grad)

    wd, wh, ww = SWIN_WINDOW
    hw, n_tok = wh * ww, wd * wh * ww
    tot = {k: Totals() for k in ("mlp_fwd", "mlp_bwd", "heads_fwd",
                                 "heads_bwd")}
    swin_b_heads = {"heads_fwd": 0.0, "heads_bwd": 0.0}   # device ms, 24 sites
    models = (("swin-T", SWIN_T_STAGES), ("swin-B", SWIN_STAGES))

    # rows 8 and 9: the MLP without the LayerNorm
    grads = ("dx", "dw1", "db1", "dw2", "db2")
    for model, stages in models:
        for stage, (c, _nh, tokens, _nw, depth) in enumerate(stages):
            f, m_rows = 4 * c, 2 * tokens
            w1, b1 = randn(f, c, scale=c ** -0.5), 0.1 * randn(f)
            w2, b2 = randn(c, f, scale=f ** -0.5), 0.1 * randn(c)
            x, g = randn(m_rows, c, scale=1.5), randn(m_rows, c)
            got = cm.mlp_fwd_cuda(x, w1, b1, w2, b2, save_residuals=True)
            want = cm.mlp_reference(x, w1, b1, w2, b2, save_residuals=True)
            tag = f"{model} M={m_rows} C={c} F={f}"
            err = max(check_close(f"mlp fwd {tag} {nm}", p, q, MLP_TOL)
                      for nm, p, q in zip(("o", "a", "s"), got, want))
            if not torch.equal(cm.mlp_fwd_cuda(x, w1, b1, w2, b2), got[0]):
                raise AssertionError(f"mlp fwd {tag}: o differs without the "
                                     "residuals")
            _o, a, s_ = got
            del got, want, _o
            args = (x, a, s_, g, w1, w2)
            got = cm.mlp_bwd_cuda(*args)
            want = cm.mlp_backward_reference(*args)
            err_b = max(check_scaled(f"mlp bwd {tag} {nm}", p, q, MLP_BWD_TOL)
                        for nm, p, q in zip(grads, got, want))
            if not all(torch.equal(p, q)
                       for p, q in zip(cm.mlp_bwd_cuda(*args), got)):
                raise AssertionError(f"mlp bwd {tag}: two runs differ")
            del got, want
            leaves = [v.detach().clone().requires_grad_()
                      for v in (x, w1, b1, w2, b2)]
            with torch.enable_grad():
                o_lib = cm.mlp_reference(*leaves)
            t = {"fwd": quick(lambda: cm.mlp_fwd_cuda(x, w1, b1, w2, b2)),
                 "fwd keeping a, s": quick(lambda: cm.mlp_fwd_cuda(
                     x, w1, b1, w2, b2, save_residuals=True)),
                 "fwd plain (F.linear-gelu-F.linear)": quick(
                     lambda: cm.mlp_reference(x, w1, b1, w2, b2)),
                 "bwd": quick(lambda: cm.mlp_bwd_cuda(*args)),
                 "bwd plain": quick(
                     lambda: cm.mlp_backward_reference(*args)),
                 "bwd of the composition": quick(
                     lambda: torch.autograd.grad(o_lib, leaves, g,
                                                 retain_graph=True),
                     grad=True)}
            _report(f"mlp {tag}", max(err, err_b), t)
            flops = 4 * m_rows * c * f + 10 * m_rows * f
            bflops = 8 * m_rows * c * f + 4 * m_rows * f
            for d, fl in (("fwd", flops), ("bwd", bflops)):
                if t[d][1]:
                    print(f"  {d} kernel rate: {fl / t[d][1] / 1e9:.1f} "
                          "TFLOP/s float32 (operations over device time)",
                          flush=True)
            tot["mlp_fwd"].err = max(tot["mlp_fwd"].err, err)
            tot["mlp_bwd"].err = max(tot["mlp_bwd"].err, err_b)
            # the sites of the model's path: Swin-T's stages 1 and 2
            if model == "swin-T" and stage < 2:
                plain = t["fwd plain (F.linear-gelu-F.linear)"]
                tot["mlp_fwd"].add(
                    depth, ms=t["fwd"][0], device_ms=t["fwd"][1],
                    plain_ms=plain[0], plain_device_ms=plain[1],
                    bytes=(2 * m_rows * c + 2 * c * f + f + c) * 4,
                    flops=flops, tc_flops=4 * m_rows * c * f)
                tot["mlp_bwd"].add(
                    depth, ms=t["bwd"][0], device_ms=t["bwd"][1],
                    plain_ms=t["bwd plain"][0],
                    plain_device_ms=t["bwd plain"][1],
                    library_ms=t["bwd of the composition"][0],
                    library_device_ms=t["bwd of the composition"][1],
                    bytes=(3 * m_rows * c + 2 * m_rows * f + 4 * c * f + f
                           + c) * 4, flops=bflops, tc_flops=8 * m_rows * c * f)
            del x, g, a, s_, args, leaves, o_lib

    # rows 12 and 13: the attention per (head, window)
    for model, stages in models:
        for c, nh, tokens, nw, depth in stages:
            hd = c // nh
            scale = hd ** -0.5
            dense = cb.expand_bias_reference(
                randn(nh, 2 * wd - 1, hw, hw), wd)
            mask = None
            if nw > 1:
                mask = torch.where(
                    torch.rand(nw, n_tok, n_tok, device=dev,
                               generator=gen) < 0.3, -100.0, 0.0)
                mask.diagonal(dim1=1, dim2=2).zero_()
            b_ = 2 * tokens // n_tok
            qkv = randn(b_, n_tok, 3 * c)
            q, k, v = qkv.reshape(b_, n_tok, 3, nh, hd).unbind(2)
            g = randn(b_, n_tok, nh, hd)
            for m in ((None, mask) if mask is not None else (None,)):
                tag = (f"{model} B_={b_} N={n_tok} nh={nh} hd={hd} mask="
                       f"{m is not None}")
                want = ca.attention_reference(q, k, v, dense, m, scale)
                err = check_close(f"attention (heads) fwd {tag}",
                                  ca.attn_heads_fwd_cuda(q, k, v, dense, m,
                                                         scale),
                                  want, ATTN_TOL)
                del want
                # the backward reads the row maximum and sum its forward
                # kept; the plain version rebuilds them from the logits
                _o, ms_h = ca.attn_heads_fwd_cuda(q, k, v, dense, m, scale,
                                                  save_ms=True)
                got = ca.attn_heads_bwd_cuda(q, k, v, dense, m, ms_h, g, scale)
                want = ca.heads_attention_backward_reference(q, k, v, dense,
                                                             m, g, scale)
                err_b = max(check_scaled(f"attention (heads) bwd {tag} {nm}",
                                         p_, q_, ATTN_BWD_TOL)
                            for nm, p_, q_ in zip(("dq", "dk", "dv", "dbias"),
                                                  got, want))
                again = ca.attn_heads_bwd_cuda(q, k, v, dense, m, ms_h, g,
                                               scale)
                if not all(torch.equal(p_, q_) for p_, q_ in zip(again, got)):
                    raise AssertionError(f"attention (heads) bwd {tag}: two "
                                         "runs differ")
                del got, want, again, _o
                launches = check_attn_bwd_launches(
                    f"attention (heads) bwd {tag}",
                    lambda: ca.attn_heads_bwd_cuda(q, k, v, dense, m, ms_h, g,
                                                   scale),
                    ca.bwd_split(b_, nh, dev))
                q5 = qkv.reshape(b_, n_tok, 3, nh, hd).permute(2, 0, 3, 1, 4)
                leaves = [q5[i].detach().requires_grad_() for i in range(3)]
                am = dense[None] if m is None else (
                    dense[None, None] + m[None, :, None]).expand(
                        b_ // nw, nw, nh, n_tok, n_tok).reshape(
                            b_, nh, n_tok, n_tok)
                with torch.enable_grad():
                    o_lib = F.scaled_dot_product_attention(
                        *leaves, attn_mask=am, scale=scale)
                g4 = g.permute(0, 2, 1, 3)
                t = {"fwd": quick(lambda: ca.attn_heads_fwd_cuda(
                         q, k, v, dense, m, scale)),
                     "fwd plain": quick(lambda: ca.attention_reference(
                         q, k, v, dense, m, scale)),
                     "fwd sdpa": quick(
                         lambda: F.scaled_dot_product_attention(
                             q5[0], q5[1], q5[2], attn_mask=am, scale=scale)),
                     "bwd": quick(lambda: ca.attn_heads_bwd_cuda(
                         q, k, v, dense, m, ms_h, g, scale)),
                     "bwd plain": quick(
                         lambda: ca.heads_attention_backward_reference(
                             q, k, v, dense, m, g, scale)),
                     "bwd sdpa": quick(lambda: torch.autograd.grad(
                         o_lib, leaves, g4, retain_graph=True), grad=True)}
                _report(f"attention (heads) {tag}, backward {launches} "
                        "launches, none of the forward kernel",
                        max(err, err_b), t)
                tot["heads_fwd"].err = max(tot["heads_fwd"].err, err)
                tot["heads_bwd"].err = max(tot["heads_bwd"].err, err_b)
                # shifted blocks are every second one where there is a mask
                sites = depth // 2 if mask is not None else depth
                if model == "swin-B":
                    for d in ("fwd", "bwd"):
                        key = f"heads_{d}"
                        swin_b_heads[key] = None if (
                            t[d][1] is None or swin_b_heads[key] is None) \
                            else swin_b_heads[key] + sites * t[d][1]
                    del leaves, am, o_lib, ms_h
                    continue
                small = dense.numel() + (0 if m is None else m.numel())
                pairs = b_ * nh * n_tok * n_tok
                tot["heads_fwd"].add(
                    sites, ms=t["fwd"][0], device_ms=t["fwd"][1],
                    plain_ms=t["fwd plain"][0],
                    plain_device_ms=t["fwd plain"][1],
                    library_ms=t["fwd sdpa"][0],
                    library_device_ms=t["fwd sdpa"][1],
                    bytes=(4 * b_ * n_tok * c + small) * 4,
                    flops=pairs * (4 * hd + 6), tc_flops=pairs * 4 * hd)
                tot["heads_bwd"].add(
                    sites, ms=t["bwd"][0], device_ms=t["bwd"][1],
                    plain_ms=t["bwd plain"][0],
                    plain_device_ms=t["bwd plain"][1],
                    library_ms=t["bwd sdpa"][0],
                    library_device_ms=t["bwd sdpa"][1],
                    bytes=(7 * b_ * n_tok * c + ms_h.numel() + small
                           + dense.numel()) * 4,
                    flops=pairs * (10 * hd + 12), tc_flops=pairs * 10 * hd)
                del leaves, am, o_lib, ms_h
            del qkv, q, k, v, g

    src, ops = "vitta_tpu_torch/csrc", "vitta_tpu/ops"
    rows = [tot["mlp_fwd"].row("mlp_fwd", f"{src}/mlp.cu",
                               f"{ops}/pallas_mlp.py:138", has_library=False),
            tot["mlp_bwd"].row("mlp_bwd", f"{src}/mlp.cu",
                               f"{ops}/pallas_mlp.py:154", has_library=False),
            tot["heads_fwd"].row("attn_heads_fwd", f"{src}/attention.cu",
                                 f"{ops}/pallas_attention.py:83"),
            tot["heads_bwd"].row("attn_heads_bwd", f"{src}/attention.cu",
                                 f"{ops}/pallas_attention.py:91")]
    # no one PyTorch call computes the MLP: its forward composition is the
    # plain version, its backward composition is kept beside the row
    rows[0]["composition_device_ms"] = rows[0]["plain_device_ms"]
    rows[1]["composition_device_ms"] = tot["mlp_bwd"].sum["library_device_ms"]
    rows[2]["swin_b_device_ms"] = swin_b_heads["heads_fwd"]
    rows[3]["swin_b_device_ms"] = swin_b_heads["heads_bwd"]
    fwd, bwd = swin_launches("heads", 96, (2, 2, 6, 2))
    per_pass = {**fwd, **bwd}
    for r in rows:
        extra = (f", the composition device "
                 f"{fmt(r['composition_device_ms'])}"
                 if "composition_device_ms" in r else
                 f", at Swin-B's 24 blocks device "
                 f"{fmt(r['swin_b_device_ms'])}")
        print(f"{r['name']} per Swin-T pass of 2 clips "
              f"({per_pass[r['name']]} launches): event ms {r['ms']:.3f}, "
              f"device ms {fmt(r['device_ms'])}, plain {r['plain_ms']:.3f} "
              f"(device {fmt(r['plain_device_ms'])}), library "
              f"{fmt(r['library_ms'])} (device "
              f"{fmt(r['library_device_ms'])}){extra}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}{_floor(r)}",
              flush=True)
    return rows


def _gemm_device_ms(fn):
    """Device ms of one call of ``fn`` in its products, from torch.profiler:
    the gemm_tiles and gemm_pair launches and the reduce_partials or
    reduce_sums launches that add a weight gradient's k-chunk partials
    (they also finish the bias column sums and, in the projection-fused
    attention with the LayerNorm, its dgamma and dbeta, which this counts
    too).  torch.profiler now and then records no kernel of a call (see
    ``device_ms``), so it is asked up to three times; raises where it
    recorded no gemm_tiles or gemm_pair launch in any of them."""
    gemm = ("gemm_tiles", "gemm_pair")
    for _attempt in range(3):
        _host, _busy, rows = device_breakdown(fn, top=None)
        if any(k in name for name, _t, _n in rows for k in gemm):
            break
    else:
        raise AssertionError("the profiler recorded no gemm_tiles launch")
    return sum(t for name, t, _n in rows
               if any(k in name for k in gemm + ("reduce_partials",
                                                 "reduce_sums")))


def phase_gemm_rates(dev):
    """gemm_tiles' rate at every Swin-B and Swin-T stage shape of 2 clips:
    float32-equivalent operations (2MNK per product) over the device time of
    its launches and of the partial sums' reduce_partials launches in one
    call, for the MLP's two forward and four backward
    products (rows 8-11) and, at Swin-B's shapes, the projection-fused
    attention's two forward and four backward products (rows 16-19; the
    backward reads the qkv its forward kept); beside it ``torch.matmul`` (TF32 off) on
    the same products, device time from the profiler.  Returns {shape:
    {call: (gemm_tiles TFLOP/s, torch.matmul TFLOP/s)}}."""
    from vitta_tpu_torch.ops import cuda_attention_proj as cp
    from vitta_tpu_torch.ops import cuda_bias as cb
    from vitta_tpu_torch.ops import cuda_mlp as cm
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    wd, wh, ww = SWIN_WINDOW
    hw, n_tok = wh * ww, wd * wh * ww
    out = {}
    for model, stages in (("swin-B", SWIN_STAGES), ("swin-T", SWIN_T_STAGES)):
        for c, nh, tokens, _nw, _depth in stages:
            m, f = 2 * tokens, 4 * c
            x, g = randn(m, c, scale=1.5), randn(m, c)
            w1, b1 = randn(f, c, scale=c ** -0.5), 0.1 * randn(f)
            w2, b2 = randn(c, f, scale=f ** -0.5), 0.1 * randn(c)
            _o, a, s_ = cm.mlp_fwd_cuda(x, w1, b1, w2, b2, save_residuals=True)
            calls = {
                "mlp forward": (lambda: cm.mlp_fwd_cuda(x, w1, b1, w2, b2),
                                lambda: (x @ w1.t(), a @ w2.t()),
                                4 * m * c * f),
                "mlp backward": (
                    lambda: cm.mlp_bwd_cuda(x, a, s_, g, w1, w2),
                    lambda: (g @ w2, a @ w1, a.t() @ x, g.t() @ a),
                    8 * m * c * f)}
            if model == "swin-B":
                b_, hd = m // n_tok, c // nh
                x3, g3 = x.reshape(b_, n_tok, c), g.reshape(b_, n_tok, c)
                wqkv = randn(3 * c, c, scale=c ** -0.5)
                bqkv = 0.1 * randn(3 * c)
                wproj, bproj = randn(c, c, scale=c ** -0.5), 0.1 * randn(c)
                dense = cb.expand_bias_reference(
                    randn(nh, 2 * wd - 1, hw, hw), wd)
                w = (wqkv, bqkv, wproj, bproj)
                _o, qkv3, o_att, ms_ = cp.attn_proj_fwd(x3, *w, dense, None,
                                                        hd ** -0.5, nh, True)
                qkv = qkv3.reshape(m, 3 * c)
                calls["proj forward"] = (
                    lambda: cp.attn_proj_fwd(x3, *w, dense, None, hd ** -0.5,
                                             nh),
                    lambda: (x @ wqkv.t(), x @ wproj.t()), 8 * m * c * c)
                calls["proj backward"] = (
                    lambda: cp.attn_proj_bwd(x3, qkv3, wqkv, wproj, dense,
                                             None, o_att, ms_, g3,
                                             hd ** -0.5, nh),
                    lambda: (g @ wproj, qkv @ wqkv, g.t() @ x, qkv.t() @ x),
                    16 * m * c * c)
            rates = {}
            for call, (kernel, library, flops) in calls.items():
                k_ms = _gemm_device_ms(kernel)
                l_ms = device_ms(library, reps=3)
                rates[call] = (flops / k_ms / 1e9,
                               None if l_ms is None else flops / l_ms / 1e9)
            shape = f"{model} M={m} C={c}"
            print(f"gemm_tiles {shape}: " + ", ".join(
                f"{call} {r:.1f} TFLOP/s (torch.matmul {fmt(lib)})"
                for call, (r, lib) in rates.items())
                  + " (2MNK over device time, gemm_tiles with its partial sums' "
                  "reduce_partials, TF32 off in torch)", flush=True)
            out[shape] = rates
            del x, g, a, s_, calls
    return out


def start_ptxas_report(build):
    """nvcc of csrc/mlp.cu with ``-Xptxas -v`` into the build directory,
    started beside build_all (the kernels' own build keeps its flags):
    the report ``wgmma_build_report`` reads."""
    out = build.BUILD_DIR / "ptxas_report_mlp.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out), str(build.CSRC_DIR / "mlp.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wgmma_build_report(build, proc):
    """One line on every gemm_wgmma_bf16 instance of the mlp library and one
    on every instance of the fused MLP without the LayerNorm
    (mlp_rows_bf16, csrc/mlp_fused_bf16.cuh): registers and spills (ptxas
    -v), dynamic shared memory (the plans' formulas,
    ``cuda_mlp.wgmma_smem_bytes`` and ``cuda_mlp.mlp_rows_smem``) and the
    HGMMA instructions in the SASS of the built library (cuobjdump -sass):
    wgmma runs there.  Raises where one spills or has no HGMMA."""
    import collections
    import re
    from vitta_tpu_torch.ops.cuda_mlp import mlp_rows_smem, wgmma_smem_bytes
    _out, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"nvcc -Xptxas -v of mlp.cu failed:\n{err}")
    ptx = {}
    name = None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and ("gemm_wgmma_bf16" in name or "mlp_rows_bf16" in name):
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                ptx.setdefault(name, {})["spills"] = (int(m.group(1)),
                                                      int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                ptx.setdefault(name, {})["regs"] = int(m.group(1))
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.build("mlp"))],
                          capture_output=True, text=True, check=True).stdout
    parts, fused = [], []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        fn = part.split("\n", 1)[0].strip()
        if "gemm_wgmma_bf16" not in fn and "mlp_rows_bf16" not in fn:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                part))
        if "mlp_rows_bf16" in fn:
            c, bwd = re.search(r"mlp_rows_bf16ILi(\d+)ELb(\d)E", fn).groups()
            info = ptx.get(fn, {})
            spills = info.get("spills", (None, None))
            if ops["HGMMA"] == 0 or spills != (0, 0):
                raise AssertionError(f"{fn}: {ops['HGMMA']} HGMMA, spills "
                                     f"{spills}")
            sa, ss, sb, smem = mlp_rows_smem(int(c), bwd == "1")
            fused.append(f"<{c}, {'row pass' if bwd == '1' else 'forward'}>"
                         f": {info.get('regs')} registers at launch (232 a "
                         f"consumer thread after setmaxnreg), spill "
                         f"stores/loads {spills[0]}/{spills[1]} bytes, rings "
                         f"A/S/B {sa}/{ss}/{sb} slots, dynamic shared memory "
                         f"{smem} bytes, HGMMA {ops['HGMMA']} of "
                         f"{sum(ops.values())} instructions")
            continue
        bm, bn, stages, epi = (int(v) for v in re.findall(r"Li(\d+)E", fn))
        promote, a_mn, b_mn = re.findall(r"Lb(\d)E", fn)
        info = ptx.get(fn, {})
        spills = info.get("spills", (None, None))
        if ops["HGMMA"] == 0 or spills != (0, 0):
            raise AssertionError(f"{fn}: {ops['HGMMA']} HGMMA, spills "
                                 f"{spills}")
        parts.append(f"<{bm}x{bn}, {stages} slots, promotion {promote}, A "
                     f"MN-major {a_mn}, B MN-major {b_mn}, epilogue {epi}>: "
                     f"{info.get('regs')} registers at launch, spill "
                     f"stores/loads {spills[0]}/{spills[1]} bytes, dynamic "
                     f"shared memory {wgmma_smem_bytes(bm, bn, stages)} "
                     f"bytes, HGMMA {ops['HGMMA']} of {sum(ops.values())} "
                     f"instructions")
    if not parts or not fused:
        raise AssertionError("no gemm_wgmma_bf16 or mlp_rows_bf16 kernel in "
                             "the mlp library")
    print(f"gemm_wgmma_bf16 instances in csrc/mlp.cu ({len(parts)}; ptxas -v, "
          "cuobjdump -sass; epilogue 0 bias, 1 GELU, 2 * s, 3 + gy, 4 "
          "partials): "
          + "; ".join(parts), flush=True)
    print(f"mlp_rows_bf16 instances in csrc/mlp_fused_bf16.cuh "
          f"({len(fused)}; ptxas -v, cuobjdump -sass): " + "; ".join(fused),
          flush=True)


def phase_wgmma_rates(dev):
    """Phase 21 at bfloat16: the wgmma core's rate for each of the
    LayerNorm-MLP's six products (rows 10 bf16 and 11 bf16) at every Swin-B
    stage shape of 2 clips, 2MNK over the device ms of one call by CUDA
    graphs' replays (``graph_ms``; the call is the product with its
    epilogue, dh's with db1's column partials, a weight gradient with the
    reduce_partials of its chunks where its plan cuts K; dw1 and dw2 each
    alone, where the backward runs them in one launch), beside
    ``torch.matmul`` at bfloat16 on the same operands (a yardstick the port
    never calls), and each product's plan.  Returns {shape: {product:
    (core TFLOP/s, torch.matmul TFLOP/s)}}."""
    from vitta_tpu_torch.ops import cuda_mlp as cm
    gen = torch.Generator(device=dev).manual_seed(6)

    def bf(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).to(torch.bfloat16)

    out = {}
    for c, _nh, tokens, _nw, _depth in SWIN_STAGES:
        m, f = 2 * tokens, 4 * c
        y, w1, b1 = bf(m, c), bf(f, c, scale=c ** -0.5), bf(f, scale=0.1)
        a, w2, b2 = bf(m, f), bf(c, f, scale=f ** -0.5), bf(c, scale=0.1)
        go, s_, gy, dhc = bf(m, c), bf(m, f), bf(m, c, scale=0.1), bf(m, f)
        prod = cm.bf16_product_cuda
        calls = {
            "h": (lambda: prod("h", y, w1, b1), lambda: y @ w1.t()),
            "o": (lambda: prod("o", a, w2, b2), lambda: a @ w2.t()),
            "dh": (lambda: prod("dh", go, w2, aux=s_), lambda: go @ w2),
            "dy": (lambda: prod("dy", dhc, w1, aux=gy), lambda: dhc @ w1),
            "dw1": (lambda: prod("dw1", dhc, y), lambda: dhc.t() @ y),
            "dw2": (lambda: prod("dw2", go, a), lambda: go.t() @ a)}
        flops = 2 * m * c * f
        rates = {k: (flops / graph_ms(kern) / 1e9, flops / graph_ms(lib) / 1e9)
                 for k, (kern, lib) in calls.items()}
        plan = cm.bf16_gemm_plan_cuda(m, c, f)
        shape = f"swin-B M={m} C={c}"
        print(f"gemm_wgmma_bf16 {shape}: " + ", ".join(
            f"{k} {r:.1f} TFLOP/s (torch.matmul {lib:.1f}; tile "
            f"{plan[k]['bm']}x{plan[k]['bn']}, {plan[k]['splits']} chunks of "
            f"K, grid {plan[k]['grid']})"
            for k, (r, lib) in rates.items())
              + " (2MNK over device time, CUDA graphs' replays)", flush=True)
        out[shape] = rates
        del y, w1, b1, a, w2, b2, go, s_, gy, dhc, calls
    return out


def bn_stats_one_launch_and_graph(what, x2, scale, bias, mean, var, cots,
                                  relu=False):
    """The BatchNorm-statistics kernels' forward and backward on one
    input: each call one launch, of the input's dtype (the library's own
    counts), and a CUDA graph of both calls replayed twice giving the eager
    calls' bits (the tickets are left at 0 by every launch and the graph
    replays the stream's slot as it is)."""
    from vitta_tpu_torch.ops.cuda_stats import (bn_stats_bwd_cuda,
                                                bn_stats_fwd_cuda)

    def run():
        y, m, v = bn_stats_fwd_cuda(x2, scale, bias, mean, var, 1e-5, relu)
        return [y, m, v, *bn_stats_bwd_cuda(x2, scale, bias, mean, var, m,
                                            *cots, 1e-5, relu)]
    bf16 = x2.dtype == torch.bfloat16
    for d in ("fwd", "bwd"):
        names = launches_of(
            (lambda: bn_stats_fwd_cuda(x2, scale, bias, mean, var, 1e-5,
                                       relu)) if d == "fwd" else
            (lambda: bn_stats_bwd_cuda(
                x2, scale, bias, mean, var, mean, *cots, 1e-5, relu)))
        if (sum(names.values()) != 1
                or not all(k.startswith(f"bn_stats_{d}_kernel")
                           and ("bfloat16" in k) == bf16 for k in names)):
            raise AssertionError(f"{what} {d}: launches {names}, expected "
                                 f"one bn_stats_{d}_kernel a call")
    want = [t.clone() for t in run()]
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for name, a, b in zip(("y", "m", "v", "dx", "dscale", "dbias"), got,
                              want):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: a CUDA graph's replay differs "
                                     f"from the eager call in {name}")
    del graph


def phase_bn_stats_kernels(dev):
    """The BatchNorm-statistics kernels against plain on the card, forward
    and backward with cotangents on y, m and v, ``relu`` False and True, at
    every BatchNorm2d shape a TANet mean_var step reads and the two
    BatchNorm1d shapes of a TAM; returns the two JSON rows, their times
    summed over one adapt pass (``relu=False``, the form ``BatchNorm``
    calls).  No one PyTorch call returns y and the statistics: the
    composition ``F.batch_norm`` (eval form) + ``torch.var_mean`` and its
    backward under autograd are timed beside the kernels."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_stats
    from vitta_tpu_torch.ops.cuda_stats import (
        bn_stats_bwd_cuda, bn_stats_fwd_cuda, fused_bn_relu_stats,
        fused_bn_relu_stats_reference)
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=gen)

    def value_and_grads(fn, relu, x, scale, bias, mean, var, cots):
        ins = [t.clone().requires_grad_() for t in (x, scale, bias)]
        y, (m, v) = fn(*ins, mean, var, relu=relu)
        torch.autograd.backward((y, m, v), cots)
        return [y.detach(), m.detach(), v.detach()] + [t.grad for t in ins]

    fwd, bwd = Totals(), Totals()
    comp = dict.fromkeys(("fwd", "bwd", "fwd_device", "bwd_device"), 0.0)
    shapes = [((r, c), n, f"{r}x{c}") for (r, c), n in BN_SITES.items()]
    shapes += [(shape, 0, name) for shape, name in BN1D_SHAPES]
    for shape, sites, label in shapes:
        c = shape[-1]
        x = rand(*shape) * 2.0 + 0.5
        scale, bias = torch.rand(c, device=dev, generator=gen) + 0.5, rand(c)
        mean = rand(c) * 0.1
        var = torch.rand(c, device=dev, generator=gen) + 0.5
        cots = (rand(*shape), rand(c), rand(c))
        for relu in (False, True):
            cuda_stats.counters.reset()
            got = value_and_grads(fused_bn_relu_stats, relu, x, scale, bias,
                                  mean, var, cots)
            again = value_and_grads(fused_bn_relu_stats, relu, x, scale, bias,
                                    mean, var, cots)
            if (cuda_stats.counters.fwd, cuda_stats.counters.bwd) != (2, 2):
                raise AssertionError("bn_stats: a call did not launch")
            want = value_and_grads(fused_bn_relu_stats_reference, relu, x,
                                   scale, bias, mean, var, cots)
            torch.cuda.synchronize()
            what = f"bn_stats {label} relu={relu}"
            e_f = max(check_close(f"{what} y", got[0], want[0], BN_TOL),
                      check_close(f"{what} m", got[1], want[1], BN_TOL, 1e-6),
                      check_close(f"{what} v", got[2], want[2], 1e-4, 1e-5))
            e_b = max(check_scaled(f"{what} {n}", g, w, BN_BWD_TOL)
                      for n, g, w in zip(("dx", "dscale", "dbias"), got[3:],
                                         want[3:]))
            for n, a, b in zip(("y", "m", "v", "dx", "dscale", "dbias"), got,
                               again):
                if not torch.equal(a, b):
                    raise AssertionError(f"{what}: two runs differ in {n}")
            fwd.err, bwd.err = max(fwd.err, e_f), max(bwd.err, e_b)
            bn_stats_one_launch_and_graph(
                what, x.reshape(-1, c), scale, bias, mean, var,
                (cots[0].reshape(-1, c), cots[1], cots[2]), relu)
            if sites == 0 or relu:
                print(f"{what}: max abs err fwd {e_f:.2e} bwd {e_b:.2e}, two "
                      "runs and a CUDA graph's replays bit-equal, one launch "
                      "a call each way", flush=True)
        if sites == 0:
            continue
        x2 = x.reshape(-1, c)
        m = bn_stats_fwd_cuda(x2, scale, bias, mean, var, 1e-5, False)[1]
        ref_in = [t.clone().requires_grad_() for t in (x2, scale, bias)]
        ref_y, (ref_m, ref_v) = fused_bn_relu_stats_reference(
            *ref_in, mean, var, relu=False)

        def composition(xi, wi, bi):
            y = F.batch_norm(xi, mean, var, wi, bi, False, 0.0, 1e-5)
            v, mm = torch.var_mean(y, dim=0, unbiased=False)
            return y, mm, v

        comp_out = composition(*ref_in)
        with torch.no_grad():
            check_close(f"bn_stats {label} composition", comp_out[0], ref_y,
                        1e-4)
        calls = {
            "fwd": (lambda: bn_stats_fwd_cuda(x2, scale, bias, mean, var,
                                              1e-5, False), False),
            "bwd": (lambda: bn_stats_bwd_cuda(x2, scale, bias, mean, var, m,
                                              *cots, 1e-5, False), False),
            "plain_fwd": (lambda: fused_bn_relu_stats_reference(
                x2, scale, bias, mean, var, relu=False), False),
            "plain_bwd": (lambda: torch.autograd.grad(
                (ref_y, ref_m, ref_v), ref_in, cots, retain_graph=True), True),
            "comp_fwd": (lambda: composition(x2, scale, bias), False),
            "comp_bwd": (lambda: torch.autograd.grad(
                comp_out, ref_in, cots, retain_graph=True), True)}
        t = {k: measure(fn, reps=6, dev_reps=4, grad=grad)
             for k, (fn, grad) in calls.items()}
        _report(f"bn_stats {label} ({sites} sites)", max(e_f, e_b), t)
        n = x.numel()
        nbytes = {"fwd": (2 * n + 6 * c) * 4, "bwd": (3 * n + 10 * c) * 4}
        fwd.add(sites, ms=t["fwd"][0], plain_ms=t["plain_fwd"][0],
                device_ms=t["fwd"][1], plain_device_ms=t["plain_fwd"][1],
                bytes=nbytes["fwd"], flops=6 * n)
        bwd.add(sites, ms=t["bwd"][0], plain_ms=t["plain_bwd"][0],
                device_ms=t["bwd"][1], plain_device_ms=t["plain_bwd"][1],
                bytes=nbytes["bwd"], flops=12 * n)
        print("  " + "; ".join(
            f"{d} device us {fmt(t[d][1] and t[d][1] * 1e3)} against its "
            f"bound {bound(nbytes[d], 0)[0] * 1e3:.2f} us"
            for d in ("fwd", "bwd")), flush=True)
        for d in ("fwd", "bwd"):
            comp[d] += sites * t[f"comp_{d}"][0]
            dv = t[f"comp_{d}"][1]
            comp[f"{d}_device"] = (None if dv is None
                                   or comp[f"{d}_device"] is None
                                   else comp[f"{d}_device"] + sites * dv)
        del x, x2, cots, ref_in, ref_y, comp_out, got, again, want
    rows = []
    for d, tot in (("fwd", fwd), ("bwd", bwd)):
        # the TPU function has no backward: both rows stand for its one site
        row = tot.row(f"bn_stats_{d}", "vitta_tpu_torch/csrc/bn_stats.cu",
                      "vitta_tpu/ops/pallas_stats.py:68", has_library=False)
        row["composition_ms"] = comp[d]
        row["composition_device_ms"] = comp[f"{d}_device"]
        rows.append(row)
        print(f"bn_stats_{d} per TANet adapt pass (29 sites, relu=False): "
              f"device ms kernel {fmt(row['device_ms'])} plain "
              f"{fmt(row['plain_device_ms'])} composition (F.batch_norm + "
              f"torch.var_mean{', autograd' if d == 'bwd' else ''}) "
              f"{fmt(row['composition_device_ms'])}; event ms {row['ms']:.4f} "
              f"/ {row['plain_ms']:.4f} / {row['composition_ms']:.4f}; library"
              f" call: none (no one PyTorch call returns y and the "
              f"statistics); bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']}", flush=True)
    return rows


def _bf16_ulps(name, got, want):
    """(values that differ, largest difference in units of the bound) of
    two bfloat16 tensors; raises beyond one ulp of |want|, or beyond 2^-20
    of the largest |want| where that is more (a value near 0 is the
    difference of larger float32 terms, a few float32 roundings of
    those)."""
    from vitta_tpu_torch.tools.bf16_checks import assert_bf16_within
    share, ulps, _err = assert_bf16_within(name, got, want)
    return round(share * want.numel()), ulps


def _bf16_name(name: str) -> bool:
    return "bfloat16" in name or "bf16" in name


def one_launch_and_graph(what, run, kernel):
    """``run`` (one call of a kernel's wrapper) makes one launch, of
    ``kernel`` (the library's own counts); three calls, one on another
    stream, and two replays of a CUDA graph of it give the first call's
    bits (every launch leaves the tickets it drew at 0, and the graph
    replays the stream's slot as it is)."""
    names = launches_of(run)
    if names != {kernel: 1}:
        raise AssertionError(f"{what}: launches {names}, expected {kernel} "
                             "once")
    want = [t.clone() for t in run()]

    def same(got, how):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{what}: {how} differs from the first call")
    for _ in range(2):
        same(run(), "a repeat")
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = run()
    torch.cuda.current_stream().wait_stream(side)
    same(got, "a call on another stream")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    for _ in range(2):
        graph.replay()
        same(got, "a CUDA graph's replay")
    del graph


def phase_bf16_kernels(dev):
    """The TAM and BatchNorm-statistics kernels at bfloat16 against their
    plain versions (rows 1, 2 and 7 in the bfloat16 TANet): every TAM site
    of ResNet-50 at n=2 and n=1 with t=16 and at t=3, and the 29 BatchNorm
    layers of a mean_var step (6 shapes) with ``relu`` False and True.  The
    TAM's out and dx must be the plain versions' bits (bf16 x bf16 products
    are exact in float32 and the plain versions add in the kernels' order),
    dattn and dkernel within GRAD_TOL; the BatchNorm's y and dx within one
    bfloat16 ulp (``_bf16_ulps``), its statistics within BN_TOL (variance
    rtol 1e-4 / atol 1e-5) and dscale / dbias within BN_BWD_TOL of their
    largest value.  Launches per call from the libraries' counts (1 and 1
    for the TAM: the backward's tam_bwd_bf16x8_kernel adds its blocks'
    rows itself; 1 and 1 for the BatchNorm); the TAM backward's plan the
    mirror's (``bwd_plan_bf16``); two backward runs bit-equal, and the
    CUDA graph replays of each backward too; a view 2 bytes
    past a 16-byte boundary takes each kernel's one-value path.  Times per
    adapt pass beside the bound at bfloat16's bytes; returns the four JSON
    rows."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_stats
    from vitta_tpu_torch.ops.cuda_stats import (
        bn_stats_bwd_cuda, bn_stats_fwd_cuda,
        fused_bn_relu_stats_backward_reference,
        fused_bn_relu_stats_reference)
    from vitta_tpu_torch.ops.cuda_tam import (
        bwd_plan_bf16, bwd_plan_bf16_cuda, tam_bwd_cuda,
        tam_dynamic_conv_backward_reference, tam_dynamic_conv_reference,
        tam_fwd_cuda)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, device=dev, generator=gen)

    def launches_by_kind(fn):
        names = launches_of(fn)
        if any(not _bf16_name(k) for k in names
               if k.startswith(("tam_fwd", "tam_bwd_kernel", "bn_stats_fwd_k",
                                "bn_stats_bwd_k"))):
            raise AssertionError(f"a float32 kernel ran at bfloat16: {names}")
        return names

    def shifted(v):       # the same values 2 bytes past a 16-byte boundary
        buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
        out = buf[1:].view(v.shape)
        out.copy_(v)
        return out

    # ---- the TAM, rows 1 and 2
    tam = {"fwd": Totals(), "bwd": Totals()}
    differ = {"out": 0, "dx": 0}
    for (h, w, c), sites in TAM_SITES.items():
        for n, t in ((2, 16), (1, 16), (2, 3)):
            x = rand(n, t, h, w, c).to(bf16)
            g = rand(n, t, h, w, c).to(bf16)
            a = torch.sigmoid(rand(n, t, c))
            k = torch.softmax(rand(n, c, 3), -1)
            what = f"tam bf16 {(n, t, h, w, c)}"
            fwd_names = launches_by_kind(lambda: tam_fwd_cuda(x, a, k))
            bwd_names = launches_by_kind(lambda: tam_bwd_cuda(g, x, a, k))
            if (sum(fwd_names.values()) != 1
                    or bwd_names != {"tam_bwd_bf16x8_kernel": 1}):
                raise AssertionError(f"{what}: launches {fwd_names}, "
                                     f"{bwd_names}")
            plan = bwd_plan_bf16_cuda(n, t, h * w, c)
            if plan != {**bwd_plan_bf16(n, t, h * w, c, plan["sms"]),
                        "sms": plan["sms"]}:
                raise AssertionError(f"{what}: the kernel's plan {plan} is "
                                     "not bwd_plan_bf16's")
            out = tam_fwd_cuda(x, a, k)
            got = tam_bwd_cuda(g, x, a, k)
            again = tam_bwd_cuda(g, x, a, k)
            want_out = tam_dynamic_conv_reference(x, a, k)
            want = tam_dynamic_conv_backward_reference(g, x, a, k)
            torch.cuda.synchronize()
            if not torch.equal(out, want_out):
                raise AssertionError(
                    f"{what}: out is not the plain version's "
                    f"({_bf16_ulps('out', out, want_out)})")
            if not torch.equal(got[0], want[0]):
                raise AssertionError(
                    f"{what}: dx is not the plain version's "
                    f"({_bf16_ulps('dx', got[0], want[0])})")
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"{what}: two backward runs differ")
            e_b = max(check_close(f"{what} {nm}", u, v, GRAD_TOL)
                      for nm, u, v in zip(("dattn", "dkernel"), got[1:],
                                          want[1:]))
            tam["bwd"].err = max(tam["bwd"].err, e_b)
            if (n, t) != (2, 16):
                print(f"{what}: out and dx the plain versions' bits, dattn /"
                      f" dkernel max abs err {e_b:.2e}; launches "
                      f"{fwd_names}, {bwd_names}", flush=True)
                continue
            one_launch_and_graph(f"{what} bwd",
                                 lambda: tam_bwd_cuda(g, x, a, k),
                                 "tam_bwd_bf16x8_kernel")
            print(f"{what} bwd: 1 launch, repeats, another stream and CUDA "
                  f"graph replays bit-equal; plan {plan['blocks']} blocks of "
                  f"{plan['wc']} x {plan['slots']} threads, {plan['pp']} "
                  f"positions a thread, {plan['nseg']} segments", flush=True)
            calls = {"fwd": (lambda: tam_fwd_cuda(x, a, k), False),
                     "bwd": (lambda: tam_bwd_cuda(g, x, a, k), False),
                     "plain_fwd": (lambda: tam_dynamic_conv_reference(
                         x, a, k), False),
                     "plain_bwd": (lambda: tam_dynamic_conv_backward_reference(
                         g, x, a, k), False)}
            tm = {nm: measure(fn, reps=6, dev_reps=4, grad=gr)
                  for nm, (fn, gr) in calls.items()}
            _report(f"{what} ({sites} sites)", e_b, tm)
            small = (a.numel() + k.numel()) * 4
            for d, nbytes, flops in (("fwd", 2 * x.numel() * 2 + small,
                                      7 * x.numel()),
                                     ("bwd", 3 * x.numel() * 2 + 2 * small,
                                      14 * x.numel())):
                tam[d].add(sites, ms=tm[d][0], plain_ms=tm[f"plain_{d}"][0],
                           device_ms=tm[d][1],
                           plain_device_ms=tm[f"plain_{d}"][1],
                           bytes=nbytes, flops=flops)
                dv = tm[d][1]
                print(f"  {d} device us {fmt(dv and dv * 1e3)} against its "
                      f"bound {bound(nbytes, 0)[0] * 1e3:.2f} us at "
                      "bfloat16's bytes", flush=True)
    # a view 2 bytes off: the one-channel paths, the same values
    x, g = rand(2, 16, 14, 14, 256).to(bf16), rand(2, 16, 14, 14, 256).to(bf16)
    a, k = torch.sigmoid(rand(2, 16, 256)), torch.softmax(rand(2, 256, 3), -1)
    xs, gs = shifted(x), shifted(g)
    names = {**launches_by_kind(lambda: tam_fwd_cuda(xs, a, k)),
             **launches_by_kind(lambda: tam_bwd_cuda(gs, xs, a, k))}
    if ("tam_fwd_kernel<__nv_bfloat16>" not in names
            or "tam_bwd_kernel<float, __nv_bfloat16>" not in names):
        raise AssertionError(f"tam bf16 unaligned view: launches {names}")
    got = tam_bwd_cuda(gs, xs, a, k)
    want = tam_dynamic_conv_backward_reference(g, x, a, k)
    if not (torch.equal(tam_fwd_cuda(xs, a, k),
                        tam_dynamic_conv_reference(x, a, k))
            and torch.equal(got[0], want[0])):
        raise AssertionError("tam bf16 unaligned view: values differ")
    for nm, u, v in zip(("dattn", "dkernel"), got[1:], want[1:]):
        check_close(f"tam bf16 unaligned view {nm}", u, v, GRAD_TOL)
    print(f"tam bf16, a view 2 bytes past a 16-byte boundary (2, 16, 14, 14,"
          f" 256): launches {names}, out and dx the plain versions' bits",
          flush=True)
    del x, g, xs, gs, got, want

    # ---- the BatchNorm statistics, row 7
    bn = {"fwd": Totals(), "bwd": Totals()}
    comp = {"fwd": 0.0, "bwd": 0.0}
    worst_ulps = 0.0
    for (r, c), sites in BN_SITES.items():
        x = (rand(r, c) * 2.0 + 0.5).to(bf16)
        scale = torch.rand(c, device=dev, generator=gen) + 0.5
        bias, mean = rand(c), rand(c) * 0.1
        var = torch.rand(c, device=dev, generator=gen) + 0.5
        g_y, g_m, g_v = rand(r, c).to(bf16), rand(c), rand(c)
        for relu in (False, True):
            what = f"bn_stats bf16 {r}x{c} relu={relu}"
            cuda_stats.counters.reset()
            names = launches_by_kind(lambda: bn_stats_fwd_cuda(
                x, scale, bias, mean, var, 1e-5, relu))
            y, m, v = bn_stats_fwd_cuda(x, scale, bias, mean, var, 1e-5, relu)
            names_b = launches_by_kind(lambda: bn_stats_bwd_cuda(
                x, scale, bias, mean, var, m, g_y, g_m, g_v, 1e-5, relu))
            if sum(names.values()) != 1 or sum(names_b.values()) != 1:
                raise AssertionError(f"{what}: launches {names}, {names_b}")
            bn_stats_one_launch_and_graph(what, x, scale, bias, mean, var,
                                          (g_y, g_m, g_v), relu)
            got = bn_stats_bwd_cuda(x, scale, bias, mean, var, m, g_y, g_m,
                                    g_v, 1e-5, relu)
            again = bn_stats_bwd_cuda(x, scale, bias, mean, var, m, g_y, g_m,
                                      g_v, 1e-5, relu)
            y2, m2, v2 = bn_stats_fwd_cuda(x, scale, bias, mean, var, 1e-5,
                                           relu)
            want_y, (want_m, want_v) = fused_bn_relu_stats_reference(
                x, scale, bias, mean, var, relu=relu)
            want = fused_bn_relu_stats_backward_reference(
                x, scale, bias, mean, var, m, g_y, g_m, g_v, relu=relu)
            torch.cuda.synchronize()
            if not (all(torch.equal(u, v_) for u, v_ in zip(got, again))
                    and torch.equal(y, y2) and torch.equal(m, m2)
                    and torch.equal(v, v2)):
                raise AssertionError(f"{what}: two runs differ")
            n_y, u_y = _bf16_ulps(f"{what} y", y, want_y)
            n_dx, u_dx = _bf16_ulps(f"{what} dx", got[0], want[0])
            worst_ulps = max(worst_ulps, u_y, u_dx)
            e_f = max(check_close(f"{what} m", m, want_m, BN_TOL, 1e-6),
                      check_close(f"{what} v", v, want_v, 1e-4, 1e-5))
            e_b = max(check_scaled(f"{what} {nm}", u, w_, BN_BWD_TOL)
                      for nm, u, w_ in zip(("dscale", "dbias"), got[1:],
                                           want[1:]))
            bn["fwd"].err = max(bn["fwd"].err, e_f)
            bn["bwd"].err = max(bn["bwd"].err, e_b)
            print(f"{what}: y {n_y} and dx {n_dx} of {x.numel()} values an "
                  f"ulp from the plain version's, statistics max abs err "
                  f"{e_f:.2e}, dscale / dbias {e_b:.2e}; launches {names}, "
                  f"{names_b}; two runs and a CUDA graph's replays "
                  "bit-equal", flush=True)
        w_in = [t.clone().requires_grad_() for t in (x, scale, bias)]

        def composition(xi, wi, bi):
            yc = F.batch_norm(xi, mean, var, wi, bi, False, 0.0, 1e-5)
            vc, mc = torch.var_mean(yc.float(), dim=0, unbiased=False)
            return yc, mc, vc
        comp_out = composition(*w_in)
        calls = {
            "fwd": (lambda: bn_stats_fwd_cuda(x, scale, bias, mean, var,
                                              1e-5, False), False),
            "bwd": (lambda: bn_stats_bwd_cuda(x, scale, bias, mean, var, m,
                                              g_y, g_m, g_v, 1e-5, False),
                    False),
            "plain_fwd": (lambda: fused_bn_relu_stats_reference(
                x, scale, bias, mean, var, relu=False), False),
            "plain_bwd": (lambda: fused_bn_relu_stats_backward_reference(
                x, scale, bias, mean, var, m, g_y, g_m, g_v, relu=False),
                False),
            "comp_fwd": (lambda: composition(x, scale, bias), False),
            "comp_bwd": (lambda: torch.autograd.grad(
                comp_out, w_in, (g_y, g_m, g_v), retain_graph=True), True)}
        tm = {nm: measure(fn, reps=6, dev_reps=4, grad=gr)
              for nm, (fn, gr) in calls.items()}
        _report(f"bn_stats bf16 {r}x{c} ({sites} sites)",
                max(bn["fwd"].err, bn["bwd"].err), tm)
        nel = x.numel()
        nbytes = {"fwd": 2 * nel * 2 + 6 * c * 4,
                  "bwd": 3 * nel * 2 + 10 * c * 4}
        for d, flops in (("fwd", 6 * nel), ("bwd", 12 * nel)):
            bn[d].add(sites, ms=tm[d][0], plain_ms=tm[f"plain_{d}"][0],
                      device_ms=tm[d][1],
                      plain_device_ms=tm[f"plain_{d}"][1],
                      bytes=nbytes[d], flops=flops)
        print("  " + "; ".join(
            f"{d} device us {fmt(tm[d][1] and tm[d][1] * 1e3)} against its "
            f"bound {bound(nbytes[d], 0)[0] * 1e3:.2f} us at bfloat16's bytes"
            for d in ("fwd", "bwd")), flush=True)
        for d in ("fwd", "bwd"):
            dv = tm[f"comp_{d}"][1]
            comp[d] = (None if dv is None or comp[d] is None
                       else comp[d] + sites * dv)
        del x, g_y, got, again, want, want_y, w_in, comp_out
    # a view 2 bytes off: the one-value path
    x = (rand(6272, 256) * 2.0 + 0.5).to(bf16)
    scale, bias = torch.rand(256, device=dev, generator=gen) + 0.5, rand(256)
    mean = rand(256) * 0.1
    var = torch.rand(256, device=dev, generator=gen) + 0.5
    g_y = rand(6272, 256).to(bf16)
    xs, gs = shifted(x), shifted(g_y)
    names = {**launches_by_kind(lambda: bn_stats_fwd_cuda(
        xs, scale, bias, mean, var, 1e-5, False)),
        **launches_by_kind(lambda: bn_stats_bwd_cuda(
            xs, scale, bias, mean, var, mean, gs, None, None, 1e-5, False))}
    if names != {"bn_stats_fwd_kernel<1, false, __nv_bfloat16>": 1,
                 "bn_stats_bwd_kernel<1, false, __nv_bfloat16>": 1}:
        raise AssertionError(f"bn_stats bf16 unaligned view: launches {names}")
    y, m, v = bn_stats_fwd_cuda(xs, scale, bias, mean, var, 1e-5, False)
    want_y, (want_m, _wv) = fused_bn_relu_stats_reference(
        x, scale, bias, mean, var, relu=False)
    _bf16_ulps("bn_stats bf16 unaligned view y", y, want_y)
    check_close("bn_stats bf16 unaligned view m", m, want_m, BN_TOL, 1e-6)
    dx = bn_stats_bwd_cuda(xs, scale, bias, mean, var, m, gs, None, None,
                           1e-5, False)[0]
    _bf16_ulps("bn_stats bf16 unaligned view dx", dx,
               fused_bn_relu_stats_backward_reference(
                   x, scale, bias, mean, var, m, g_y, relu=False)[0])
    print(f"bn_stats bf16, a view 2 bytes past a 16-byte boundary (6272 x "
          f"256): launches {names}; y and dx within one ulp; largest y / dx "
          f"difference at the sites {worst_ulps:.2f} of the bound (one ulp, "
          f"or the floor)", flush=True)

    rows = []
    for d, line in (("fwd", 77), ("bwd", 92)):
        rows.append(tam[d].row(f"tam_{d}_bf16", "vitta_tpu_torch/csrc/tam.cu",
                               f"vitta_tpu/ops/pallas_tam.py:{line}",
                               has_library=False))
    for d in ("fwd", "bwd"):
        row = bn[d].row(f"bn_stats_{d}_bf16",
                        "vitta_tpu_torch/csrc/bn_stats.cu",
                        "vitta_tpu/ops/pallas_stats.py:68", has_library=False)
        row["composition_device_ms"] = comp[d]
        rows.append(row)
    for row in rows:
        print(f"{row['name']} per TANet adapt pass: device ms kernel "
              f"{fmt(row['device_ms'])} plain {fmt(row['plain_device_ms'])}"
              + (f" composition (F.batch_norm + torch.var_mean at bfloat16) "
                 f"{fmt(row['composition_device_ms'])}"
                 if "composition_device_ms" in row else "")
              + f"; event ms {row['ms']:.4f} / {row['plain_ms']:.4f}; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} at bfloat16's "
              "bytes; library call: none", flush=True)
    return rows


def _assert_bf16_slice(what, sd, runs, launches):
    """Card against CPU at bfloat16 (both the port): two bfloat16 runs that
    round at other points (cuDNN against oneDNN), held as
    tests/test_torch_bf16_engine.py holds the port to vitta_tpu at
    bfloat16: reg and ce losses rtol 1e-3, consistency atol 2e-4 (the
    epoch-style loop's top-1 exactly); eval logits within 2e-2 of the
    largest; each EMA layer's mean within 1e-2 of its largest, its variance
    at rtol 2e-2 / atol 1e-2 of the layer's largest v + m^2 (one ulp on
    every bfloat16 y moves E[y^2] by up to 2^-7 of it); the whole update
    within 5% of its norm, the median tensor's within 2%, every tensor's
    within 75%."""
    (m_gpu, l_gpu, p_gpu, e_gpu), (m_cpu, l_cpu, p_cpu, e_cpu) = (
        runs["cuda"], runs["cpu"])
    for i, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for f in a:     # the losses; the epoch-style loop's top-1 exactly
            ok = (abs(a[f] - b[f]) <= 2e-4 if f == "loss_consis"
                  else abs(a[f] - b[f]) <= 1e-3 * abs(b[f])
                  if f.startswith("loss") else a[f] == b[f])
            if not ok:
                raise AssertionError(f"{what}: step {i} {f}: card {a[f]} cpu "
                                     f"{b[f]}")
    logit_err = check_scaled(f"{what} eval logits", l_gpu, l_cpu, 2e-2)
    if not e_cpu:
        raise AssertionError(f"{what}: no layer was chosen")
    for k in e_cpu:
        (gm, gv), (cm, cv) = e_gpu[k], e_cpu[k]
        scale = float(cm.abs().max())
        check_close(f"{what} ema mean {k}", gm, cm, 0.0, 1e-2 * scale)
        second = float((cv.abs() + cm * cm).max())   # E[y^2]'s size
        check_close(f"{what} ema var {k}", gv, cv, 2e-2, 1e-2 * second)
    diffs, norms, each = [], [], []
    for k, p in p_cpu.items():
        dg, dc = p_gpu[k] - sd[k], p - sd[k]
        diff, norm = float((dg - dc).norm()), float(dc.norm())
        diffs.append(diff)
        norms.append(norm)
        if norm > 0:
            each.append(diff / norm)
            if diff > 0.75 * norm:
                raise AssertionError(
                    f"{what}: update of {k}: card and cpu differ by "
                    f"{diff / norm:.3f} of its norm")
    whole = float(np.linalg.norm(diffs) / np.linalg.norm(norms))
    if not (whole <= 5e-2 and float(np.median(each)) <= 2e-2):
        raise AssertionError(f"{what}: the whole update {whole:.4f}, the "
                             f"median tensor's {np.median(each):.4f} of "
                             "their norms")
    print(f"{what} card vs cpu: {m_gpu} vs {m_cpu}; eval logits max abs err "
          f"{logit_err:.2e}; EMA of {len(e_cpu)} layers within bounds; "
          f"{len(each)} parameters moved, the whole update {whole:.4f} of "
          f"its norm apart, median tensor {np.median(each):.4f}, worst "
          f"{max(each):.4f}; kernel launches {launches}",
          flush=True)


def phase_bf16_trajectories(card, n_videos, seed=SEED, t=16, hw=224,
                            device="cuda"):
    """float32 against bfloat16 on the card, the quantities of
    benchmarks/results/bf16_gate_tanet.json: the same float32 masters,
    source statistics and uint8 videos (one seeded generator a video),
    TANet at the reference operating point (tanet_ucf101_preset, dropout
    masks from the same seeds) through ``adapt_eval_step`` at each dtype.
    Returns the gate's numbers and raises beyond GATE_BOUNDS (``t``,
    ``hw`` and ``device`` other than the card's only to rehearse it)."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import video_seed
    from vitta_tpu_torch.models import get_model
    eng32, _rng = _tanet_engine(_cfg(t, 101), seed, hw=hw, device=device)
    sd = {k: v.detach().clone() for k, v in eng32.model.state_dict().items()}
    src = {k: (s.mean.cpu().numpy(), s.var.cpu().numpy())
           for k, s in eng32.reg_specs[0].source.items()}

    def stream(engine):
        state = engine.init_state()
        out = {f: [] for f in ("pred", "loss_reg", "loss_consis", "top1")}
        for i in range(n_videos):
            rng = np.random.default_rng(10_000 + i)
            views = rng.integers(0, 256, (2, t, hw, hw, 3), dtype=np.uint8)
            clip = rng.integers(0, 256, (1, t, hw, hw, 3), dtype=np.uint8)
            label = np.asarray([i % 101], np.int64)
            engine.generator.manual_seed(video_seed(seed, i))
            state, m = engine.adapt_eval_step(state, views, clip, label)
            out["pred"].append(int(m.pred[0]))
            for f in ("loss_reg", "loss_consis", "top1"):
                out[f].append(float(getattr(m, f)))
        params = torch.cat([p.detach().double().flatten()
                            for p in engine.model.parameters()])
        ema = torch.cat([t.detach().double().flatten()
                         for s in state.ema.values() for t in s])
        return {k: np.asarray(v) for k, v in out.items()}, params, ema

    t0 = time.perf_counter()
    t32, p32, e32 = stream(eng32)
    del eng32
    cfg16 = _cfg(t, 101, compute_dtype="bfloat16")
    eng16 = VittaEngine(get_model(cfg16), cfg16, sd, src, device=device)
    t16, p16, e16 = stream(eng16)
    rel = lambda a, b: float((a - b).norm() / b.norm())
    gate = {
        "n_videos": n_videos,
        "pred_agreement": float(np.mean(t32["pred"] == t16["pred"])),
        "top1_fp32": float(np.mean(t32["top1"])) / 100,
        "top1_bf16": float(np.mean(t16["top1"])) / 100,
        "reg_loss_max_absdiff": float(np.max(np.abs(t32["loss_reg"]
                                                    - t16["loss_reg"]))),
        "reg_loss_final_reldiff": float(
            abs(t32["loss_reg"][-1] - t16["loss_reg"][-1])
            / max(abs(t32["loss_reg"][-1]), 1e-9)),
        "consis_loss_max_absdiff": float(np.max(np.abs(
            t32["loss_consis"] - t16["loss_consis"]))),
        "consis_loss_max_fp32": float(np.max(t32["loss_consis"])),
        "params_rel_l2_drift": rel(p16, p32),
        "ema_rel_l2_drift": rel(e16, e32)}
    print(f"TANet fp32 against bf16 trajectories ({n_videos} videos each, "
          f"{time.perf_counter() - t0:.1f} s): " + json.dumps(gate)
          + f"; on {card}", flush=True)
    bad = [k for k, (op, lim) in GATE_BOUNDS.items()
           if not (gate[k] >= lim if op == ">=" else gate[k] <= lim)]
    if gate["consis_loss_max_absdiff"] > (
            0.1 * gate["consis_loss_max_fp32"] + 1e-4):
        bad.append("consis_loss_max_absdiff")
    if bad:
        raise AssertionError(f"bf16 trajectories beyond their bounds: {bad}")
    return gate


def _assert_updates_agree(what, sd, p_gpu, p_cpu, rel):
    """Each parameter's update from ``sd`` on the card against the CPU's, to
    ``rel`` of its norm; returns the worst ratio and how many moved."""
    worst, moved = 0.0, 0
    for k, p in p_cpu.items():
        dg, dc = p_gpu[k] - sd[k], p - sd[k]
        diff, norm = float((dg - dc).norm()), float(dc.norm())
        if diff > rel * norm + 1e-8:
            raise AssertionError(f"{what}: update of {k}: card and cpu differ "
                                 f"by {diff / (norm + 1e-12):.3e} of its norm")
        worst = max(worst, diff / (norm + 1e-12))
        moved += norm > 0
    return worst, moved


def phase_small_slice(seed, what="small slice", tta=None, optim=None,
                      epoch=False, rel=2e-2, dtype="float32"):
    """Two tta_online steps at T=2, 32x32 on the card and on the CPU, under
    the ``tta`` and ``optim`` overrides; with ``epoch`` the epoch-style
    loop (two adapt-only steps, then one evaluation pass) instead; at
    ``dtype`` "bfloat16" the bfloat16 TANet, held to ``_assert_bf16_slice``.

    Tolerances: losses and the EMA rtol 1e-3 / atol 1e-5 and eval logits
    rtol 2e-3 / atol 2e-4 (cuDNN and oneDNN float32 convs sum in different
    orders; tests/test_tanet_parity.py's bound); lr is raised to 1e-2 so
    that the weight updates stand far above float32 rounding, and each
    tensor's update agrees to ``rel`` (2%) of its norm.  Under Adam an
    element whose gradient is rounding noise moves by lr in either
    direction, so that slice runs at lr 1e-3 and 10%."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import tta_epoch_adapt
    from vitta_tpu_torch.models import get_model
    from vitta_tpu_torch.ops import cuda_stats
    cfg = _cfg(2, 101, tta=tta, optim={"lr": 1e-2, **(optim or {})},
               dropout=0.0, compute_dtype=dtype)
    torch.manual_seed(seed)
    model = get_model(cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    src = _tanet_source(model, torch.from_numpy(
        rng.normal(size=(2, 2, 32, 32, 3)).astype(np.float32)),
        cfg.tta.stat_reg)
    videos = _videos(rng, 2, 2, 32)
    cuda_stats.counters.reset()
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = VittaEngine(get_model(cfg), cfg, sd, src, device=dev)
        metrics = []
        if epoch:
            top1, state = tta_epoch_adapt(
                eng, videos, [(c, l) for _v, c, l in videos], seed=seed)
            metrics.append({"top1": top1})
        else:
            state = eng.init_state()
            for views, clip, label in videos:
                state, m = eng.adapt_eval_step(state, views, clip, label)
                metrics.append({f: float(getattr(m, f)) for f in
                                ("loss_reg", "loss_consis", "loss_ce")})
        if state.step != len(videos):
            raise AssertionError(f"{what}: {state.step} steps")
        logits = eng.eval_logits(videos[-1][1]).cpu()
        params = {k: p.detach().cpu() for k, p in eng.model.named_parameters()}
        runs[dev] = (metrics, logits, params,
                     {k: (v.mean.cpu(), v.var.cpu())
                      for k, v in state.ema.items()})
    bn_launches = (cuda_stats.counters.fwd, cuda_stats.counters.bwd)
    if dtype == "bfloat16":
        _assert_bf16_slice(what, sd, runs, bn_launches)
        return bn_launches
    (m_gpu, l_gpu, p_gpu, e_gpu), (m_cpu, l_cpu, p_cpu, e_cpu) = (
        runs["cuda"], runs["cpu"])
    for i, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for f in a:
            if not abs(a[f] - b[f]) <= 1e-5 + 1e-3 * abs(b[f]):
                raise AssertionError(f"{what}: step {i} {f}: card {a[f]} cpu "
                                     f"{b[f]}")
    logit_err = check_close(f"{what} eval logits", l_gpu, l_cpu, 2e-3, 2e-4)
    if not e_cpu:
        raise AssertionError(f"{what}: no layer was chosen")
    ema_err = max(check_close(f"{what} ema {k}", g, c, 1e-3, 1e-5)
                  for k in e_cpu for g, c in zip(e_gpu[k], e_cpu[k]))
    worst, moved = _assert_updates_agree(what, sd, p_gpu, p_cpu, rel)
    if moved == 0:
        raise AssertionError(f"{what}: no parameter moved")
    print(f"{what} card vs cpu: {m_gpu} vs {m_cpu}; eval logits max abs err "
          f"{logit_err:.2e}; EMA of {len(e_cpu)} layers max abs err "
          f"{ema_err:.2e}; {moved} parameters moved, worst update difference "
          f"{worst:.2e} of its norm; bn_stats launches fwd/bwd {bn_launches}",
          flush=True)
    return bn_launches


def phase_full_slice(seed, n_videos, card, tta=None, what="mean_var",
                     warmup=2, epoch=False, dtype="float32"):
    """TANet at the reference operating point over seeded videos, under the
    ``tta`` overrides, at ``dtype`` (float32, or the bfloat16 TANet):
    ``tta_stream``, or with ``epoch`` ``tta_epoch_adapt`` (adapt-only
    steps, then one ``validate`` pass).  The wrappers' counters and the
    libraries' own counts must agree: every call launched its kernel, of
    the run's type (a bfloat16 tensor never reaches a plain version, nor a
    float32 kernel).  Returns the launch counts of the run and a summary of
    its times."""
    from vitta_tpu_torch.adapt.loops import tta_epoch_adapt, tta_stream
    from vitta_tpu_torch.ops import cuda_stats, cuda_tam
    cfg = _cfg(16, 101, tta=tta, compute_dtype=dtype)
    engine, rng = _tanet_engine(cfg, seed)
    videos = _videos(rng, n_videos, 16, 224)
    chosen = len(engine.tap_names)
    writer = _StepTimes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_tam.counters.reset()
    cuda_stats.counters.reset()
    out = {}

    def run():
        if epoch:
            out["top1"], out["state"] = tta_epoch_adapt(
                engine, videos, [(c, l) for _v, c, l in videos], seed=seed)
            out["meters"] = None
        else:
            top1, out["state"], out["meters"] = tta_stream(
                engine, videos, seed=seed, metrics_writer=writer)
            out["top1"] = top1[0]
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    library = launches_of(run)
    wall_ms = (time.perf_counter() - t0) * 1e3
    top1, state, meters = out["top1"], out["state"], out["meters"]
    counts = {"tam_fwd": cuda_tam.counters.fwd,
              "tam_bwd": cuda_tam.counters.bwd,
              "bn_stats_fwd": cuda_stats.counters.fwd,
              "bn_stats_bwd": cuda_stats.counters.bwd}
    grad_copies = cuda_tam.counters.grad_copies
    peak = torch.cuda.max_memory_allocated()

    if meters is not None:
        for k in ("loss_reg", "loss_consis", "loss_ce"):
            if not np.isfinite(meters[k].avg):
                raise AssertionError(f"{what}: {k} is not finite: "
                                     f"{meters[k].avg}")
        if not meters["loss_reg"].avg > 0:
            raise AssertionError(f"{what}: the regularization loss is 0")
    if state.step != n_videos:
        raise AssertionError(f"{state.step} steps for {n_videos} videos")
    for k, p in engine.model.named_parameters():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{what}: {k} is not finite")
    moved = sum(not torch.equal(p.detach(), engine.init_params[k])
                for k, p in engine.model.named_parameters())
    if moved == 0:
        raise AssertionError("no parameter changed")
    ema_norm = sum(float(s.mean.abs().sum() + s.var.abs().sum())
                   for s in state.ema.values())
    if not (np.isfinite(ema_norm) and ema_norm > 0):
        raise AssertionError(f"EMA did not move (sum |ema| = {ema_norm})")
    # per video: the adapt forward (16 TAM sites) and the eval forward (16),
    # one backward.  The BatchNorm-statistics kernel runs where a step reads
    # a BatchNorm's output-side spatiotemp leaf: at every chosen layer of a
    # mean_var step, forward and backward, never in the untapped eval
    # forward, and not under BNS (input side) or cossim (another leaf).
    reads_stat = cfg.tta.stat_reg == "mean_var" and not cfg.tta.before_norm
    bn = chosen * n_videos if reads_stat else 0
    want = {"tam_fwd": 32 * n_videos, "tam_bwd": 16 * n_videos,
            "bn_stats_fwd": bn, "bn_stats_bwd": bn}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want} "
                             f"({chosen} chosen layers)")
    for bf16 in (True, False):
        got = {k: sum(n for name, n in library.items() if name.startswith(pre)
                      and "reduce" not in name
                      and ("bfloat16" in name or "bf16" in name) == bf16)
               for k, pre in (("tam_fwd", "tam_fwd"),
                              ("tam_bwd", "tam_bwd"),
                              ("bn_stats_fwd", "bn_stats_fwd_kernel"),
                              ("bn_stats_bwd", "bn_stats_bwd_kernel"))}
        if got != (counts if bf16 == (dtype == "bfloat16")
                   else dict.fromkeys(counts, 0)):
            raise AssertionError(
                f"{what}: the libraries' {'bfloat16' if bf16 else 'float32'}"
                f" launches {got} against the wrappers' {counts} at {dtype}")
    # the TAM backward: one launch a call at bfloat16 (tam_bwd_bf16x8_kernel),
    # two at float32 (the blocks' kernel and the sum of their rows)
    tam_bwd = sum(n for name, n in library.items()
                  if name.startswith("tam_bwd"))
    if tam_bwd != counts["tam_bwd"] * (1 if dtype == "bfloat16" else 2):
        raise AssertionError(f"{what}: {tam_bwd} TAM backward launches for "
                             f"{counts['tam_bwd']} calls at {dtype}")
    ms = writer.ms[warmup:] if writer.ms else [wall_ms / n_videos]
    summary = {"mode": what, "dtype": dtype, "videos": len(ms),
               "chosen": chosen,
               "median_ms": statistics.median(ms), "min_ms": min(ms),
               "max_ms": max(ms), "peak_gib": peak / 2**30}
    losses = ("" if meters is None else
              f"losses reg {meters['loss_reg'].avg:.5f} consis "
              f"{meters['loss_consis'].avg:.5f} ce "
              f"{meters['loss_ce'].avg:.5f}, ")
    print(f"full slice ({what}, {dtype}): {n_videos} videos, {chosen} "
          f"chosen layers, "
          + (f"{wall_ms / n_videos:.3f} ms/video over the adapt-only steps "
             f"and the evaluation pass (no warm-up apart)" if epoch else
             f"median {summary['median_ms']:.3f} ms/video after {warmup} "
             f"warm-up")
          + f" (host clock, synchronised on the metrics; includes the uint8 "
          f"host-to-device copy), peak memory {peak / 2**30:.3f} GiB, {moved} "
          f"parameter tensors moved, {losses}top1 {top1:.1f}; launches "
          f"{counts} (the libraries' counts of the {dtype} kernels the same),"
          f" TAM backward {tam_bwd // n_videos} launches a video (the "
          f"libraries' counts), gradient contiguity copies {grad_copies}; "
          f"on {card}",
          flush=True)

    # where the time goes: one adapt+eval step with its inputs on the card
    host_ms, busy, classes, largest = _profile_step(engine, videos[-1], state)
    if busy == 0:
        print(f"TANet adapt step ({what}, {dtype}): device time not "
              "measured", flush=True)
    else:
        summary.update(host_ms=host_ms, device_busy_ms=busy,
                       idle_share=max(0.0, 1 - busy / host_ms),
                       classes=classes)
        print(f"TANet adapt step ({what}, {dtype}), profiled: host "
              f"{host_ms:.3f} ms, "
              f"device busy {busy:.3f} ms, idle share "
              f"{summary['idle_share']:.2f}; by class, ms (launches): "
              + ", ".join(f"{k} {v[0]:.3f} ({v[1]})"
                          for k, v in classes.items())
              + "; largest kernels: "
              + "; ".join(f"{k[:50]} {t:.3f} ms x{n}" for k, t, n in largest[:6]),
              flush=True)
    return counts, summary


# ---------------------------------------------------------------------------
def _swin_model(cfg, sd, attn_route=None):
    from vitta_tpu_torch.models import get_model
    model = get_model(cfg, attn_route=attn_route)
    model.load_state_dict(sd, strict=True)
    return model


def _compare_stats(what, got, want, names):
    """Raise unless both hold exactly ``names`` and agree to rtol 1e-3 /
    atol 1e-5 (float32 sums in another order; tests/test_swin_parity.py's
    bound for tap statistics); returns the largest abs error."""
    if set(got) != set(names) or set(want) != set(names):
        raise AssertionError(f"{what}: tap names differ from the model's "
                             "norm layers")
    worst = 0.0
    for name in names:
        for kind, a, b in zip(("mean", "var"), got[name], want[name]):
            worst = max(worst, check_close(
                f"{what} {kind} {name}", torch.from_numpy(a),
                torch.from_numpy(b), 1e-3, 1e-5))
    return worst


def _swin_counts():
    from vitta_tpu_torch.models import swin
    from vitta_tpu_torch.ops import (cuda_attention, cuda_attention_proj,
                                     cuda_bias, cuda_ln, cuda_mlp)
    proj = cuda_attention_proj.counters
    return {"ln_fwd": cuda_ln.counters.fwd,
            "bias_expand": cuda_bias.counters.fwd,
            "attn_packed_fwd": cuda_attention.counters.fwd,
            "attn_heads_fwd": cuda_attention.counters.heads_fwd,
            "attn_proj_fwd": proj.proj_fwd,
            "attn_ln_proj_fwd": proj.ln_proj_fwd,
            "ln_mlp_fwd": cuda_mlp.counters.fwd,
            "mlp_fwd": cuda_mlp.counters.mlp_fwd,
            "ln_bwd": cuda_ln.counters.bwd,
            "bias_collapse": cuda_bias.counters.bwd,
            "attn_packed_bwd": cuda_attention.counters.bwd,
            "attn_heads_bwd": cuda_attention.counters.heads_bwd,
            "attn_proj_bwd": proj.proj_bwd,
            "attn_ln_proj_bwd": proj.ln_proj_bwd,
            "ln_mlp_bwd": cuda_mlp.counters.bwd,
            "mlp_bwd": cuda_mlp.counters.mlp_bwd,
            "contiguity_copies": swin.counters.contiguity_copies}


def _reset_swin_counts():
    from vitta_tpu_torch.models import swin
    from vitta_tpu_torch.ops import (cuda_attention, cuda_attention_proj,
                                     cuda_bias, cuda_ln, cuda_mlp)
    for mod in (cuda_ln, cuda_bias, cuda_attention, cuda_attention_proj,
                cuda_mlp, swin):
        mod.counters.reset()


def swin_launches(route, embed_dim=128, depths=(2, 2, 18, 2),
                  dtype="float32"):
    """(forward, backward) launches per pass, by kernel, of a Swin of this
    width and these depths (the defaults are Swin-B's) whose blocks all
    take ``route`` (None: the packed default) on full windows.  A stage
    whose width is a multiple of 128 runs norm2 inside the LayerNorm-MLP
    kernel, any other as a LayerNorm launch of its own in front of the MLP
    kernel (``dispatch.mlp_ln_fused``; the token counts of a 16x224x224
    clip are multiples of 8 at every stage).  Outside the blocks there is
    one LayerNorm per stage (patch embed, PatchMerging) and the final one.
    At bfloat16 the packed attention takes the compact bias itself: no
    expansion and no collapse launch; under ``"heads"``, ``"proj"`` and
    ``"ln_proj"`` the bias is expanded and collapsed at float32 at either
    dtype."""
    attn = {None: "attn_packed", "packed": "attn_packed", "proj": "attn_proj",
            "ln_proj": "attn_ln_proj", "heads": "attn_heads"}[route]
    blocks = sum(depths)
    fused = sum(d for i, d in enumerate(depths)
                if (embed_dim << i) % 128 == 0)
    norms = (len(depths) + 1 + (0 if route == "ln_proj" else blocks)
             + blocks - fused)
    fwd = {"ln_fwd": norms, "bias_expand": blocks, "attn_packed_fwd": 0,
           "attn_heads_fwd": 0, "attn_proj_fwd": 0, "attn_ln_proj_fwd": 0,
           "ln_mlp_fwd": fused, "mlp_fwd": blocks - fused}
    bwd = {"ln_bwd": norms, "bias_collapse": blocks, "attn_packed_bwd": 0,
           "attn_heads_bwd": 0, "attn_proj_bwd": 0, "attn_ln_proj_bwd": 0,
           "ln_mlp_bwd": fused, "mlp_bwd": blocks - fused}
    fwd[attn + "_fwd"] = bwd[attn + "_bwd"] = blocks
    if dtype == "bfloat16" and attn == "attn_packed":
        fwd["bias_expand"] = bwd["bias_collapse"] = 0
    return fwd, bwd


def phase_swin_card_vs_cpu(what, cfg, seed, sizes, t, hw, attn_route=None):
    """Source statistics and eval logits of one seeded Swin on the card
    against the CPU.  Tolerances: statistics rtol 1e-3 / atol 1e-5, logits
    rtol 2e-3 / atol 2e-4 (tests/test_swin_parity.py's bounds: float32
    products summed in different orders through the blocks)."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.precompute import compute_source_statistics
    from vitta_tpu_torch.utils.checkpoint import swin_norm_layers
    sd = _swin_weights(cfg, seed)
    rng = np.random.default_rng(seed)
    batches = _normalized_batches(rng, cfg, sizes, t, hw)
    clip = rng.integers(0, 256, (1, t, hw, hw, 3), dtype=np.uint8)
    names = [n for n, _ in swin_norm_layers(cfg.model.depths)]
    _reset_swin_counts()
    stats, logits = {}, {}
    for dev in ("cuda", "cpu"):
        stats[dev] = compute_source_statistics(
            _swin_model(cfg, sd, attn_route), batches, device=dev)
        eng = VittaEngine(_swin_model(cfg, sd, attn_route), cfg, sd,
                          stats[dev], device=dev)
        logits[dev] = eng.eval_logits(clip).cpu()
    counts = _swin_counts()
    stat_err = _compare_stats(what, stats["cuda"], stats["cpu"], names)
    logit_err = check_close(f"{what} eval logits", logits["cuda"],
                            logits["cpu"], 2e-3, 2e-4)
    for k, n in swin_launches(attn_route, cfg.model.embed_dim,
                              cfg.model.depths)[0].items():
        if n and counts[k] == 0:
            raise AssertionError(f"{what}: the {k} kernel was never launched")
    print(f"{what} card vs cpu: {len(names)} taps max abs err {stat_err:.2e}; "
          f"eval logits max abs err {logit_err:.2e} (|logit| up to "
          f"{float(logits['cpu'].abs().max()):.3f}); launches {counts}",
          flush=True)


class _TimedBatches:
    """Iterates over batches and notes the host clock at each hand-over;
    the consumer synchronises on each batch's statistics, so the gaps are
    whole batches."""

    def __init__(self, batches):
        self.batches = batches
        self.stamps = []

    def __iter__(self):
        for b in self.batches:
            self.stamps.append(time.perf_counter())
            yield b
        self.stamps.append(time.perf_counter())

    def ms(self):
        return [(b - a) * 1e3 for a, b in zip(self.stamps, self.stamps[1:])]


def phase_swin_full_slice(cfg, seed, card, attn_route=None,
                          eval_videos=SWIN_EVAL_VIDEOS, sd=None,
                          what="swin-B"):
    """The Swin of ``cfg`` (at full width and depth) through the
    source-statistics precompute and source-only evaluation under
    ``attn_route``; returns the launch counts of the run, the statistics
    as reloaded from their files, the state dict and the first video's
    eval logits."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.precompute import (
        compute_source_statistics, load_source_statistics_npz,
        save_source_statistics)
    from vitta_tpu_torch.utils.checkpoint import (load_reference_stats,
                                                  swin_norm_layers)
    arch, depths, classes = (cfg.model.arch, cfg.model.depths,
                             cfg.model.num_classes)
    t, hw = cfg.data.clip_length, cfg.data.input_size
    sd = _swin_weights(cfg, seed) if sd is None else sd
    rng = np.random.default_rng(seed)
    batches = _TimedBatches(_normalized_batches(
        rng, cfg, (2,) * SWIN_STAT_BATCHES, t, hw))
    videos = [(rng.integers(0, 256, (1, t, hw, hw, 3), dtype=np.uint8),
               np.asarray([i % classes], np.int64))
              for i in range(eval_videos)]
    names = [n for n, _ in swin_norm_layers(depths)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_swin_counts()
    stats = compute_source_statistics(_swin_model(cfg, sd, attn_route),
                                      batches)
    torch.cuda.synchronize()
    peak_stats = torch.cuda.max_memory_allocated()
    if set(stats) != set(names):
        raise AssertionError("statistics are not those of the model's "
                             f"{len(names)} norm layers")
    for name, (m, v) in stats.items():
        if not (m.ndim == 1 and m.shape == v.shape and np.isfinite(m).all()
                and np.isfinite(v).all() and (v >= 0).all()):
            raise AssertionError(f"statistics of {name} are not finite "
                                 "per-channel vectors")
    with tempfile.TemporaryDirectory() as tmp:
        mean_p, var_p, npz_p = save_source_statistics(
            stats, arch, tmp, tag="smoke", depths=depths)
        pair = load_reference_stats(mean_p, var_p, arch, depths=depths)
        npz = load_source_statistics_npz(npz_p)
    for name, (m, v) in stats.items():
        for loaded in (pair, npz):
            if not (np.array_equal(loaded[name][0], m)
                    and np.array_equal(loaded[name][1], v)):
                raise AssertionError(f"{name} changed through its file")

    engine = VittaEngine(_swin_model(cfg, sd, attn_route), cfg, sd, pair)
    torch.cuda.reset_peak_memory_stats()
    eval_ms, preds = [], []
    for clip, label in videos:
        t0 = time.perf_counter()
        top1, top5, pred = engine.eval_step(engine.init_params, clip, label)
        preds.append(int(pred.cpu()[0]))       # synchronises
        eval_ms.append((time.perf_counter() - t0) * 1e3)
        if not 0 <= preds[-1] < classes:
            raise AssertionError(f"prediction {preds[-1]} is no class")
    logits = engine.eval_logits(videos[0][0])
    if (tuple(logits.shape) != (1, classes)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"eval logits are not finite (1, {classes})")
    torch.cuda.synchronize()
    peak_eval = torch.cuda.max_memory_allocated()
    counts = _swin_counts()

    # where the time goes, with the inputs already on the card: one tapped
    # forward of 2 clips as the precompute runs it, one eval forward of 1
    from vitta_tpu_torch.models.layers import Taps
    clips2 = torch.from_numpy(batches.batches[0][0]).cuda()
    clip1 = torch.from_numpy(videos[0][0]).cuda()
    with torch.no_grad():
        for which, fn in (
                ("tapped forward of 2 clips",
                 lambda: engine.model(clips2, Taps({"stat"}), train=False)),
                ("eval forward of 1 clip",
                 lambda: engine.eval_logits(clip1))):
            host_ms, busy, rows = device_breakdown(fn)
            if busy == 0:
                print(f"{what} {which}: device time not measured",
                      flush=True)
                continue
            print(f"{what} {which}, profiled: host {host_ms:.3f} ms, device "
                  f"busy {busy:.3f} ms, idle share "
                  f"{max(0.0, 1 - busy / host_ms):.2f}; largest kernels: "
                  + "; ".join(f"{k[:60]} {ms:.3f} ms x{n}"
                              for k, ms, n in rows), flush=True)

    forwards = SWIN_STAT_BATCHES + eval_videos + 1
    want = swin_launches(attn_route, cfg.model.embed_dim, depths)[0]
    for k, per_forward in want.items():
        if counts[k] != forwards * per_forward:
            raise AssertionError(
                f"{k}: {counts[k]} launches over {forwards} forward passes, "
                f"expected {per_forward} each")
    if counts["contiguity_copies"]:
        raise AssertionError(f"{counts['contiguity_copies']} contiguity "
                             "copies on the Swin path")
    stat_ms = batches.ms()[1:]
    print(f"{what} full slice ({attn_route or 'packed'}): source statistics "
          f"{SWIN_STAT_BATCHES} batches of "
          f"2 clips, median {statistics.median(stat_ms) / 2:.3f} ms/clip "
          f"after 1 warm-up batch (host clock, each batch synchronised on "
          f"its statistics; float32 host-to-device copy included), peak "
          f"memory {peak_stats / 2**30:.3f} GiB, {len(names)} layers written "
          f"and "
          f"reloaded; source-only eval {eval_videos} videos, median "
          f"{statistics.median(eval_ms[1:]):.3f} ms/clip after 1 warm-up "
          f"(uint8 copy and normalisation included), peak memory "
          f"{peak_eval / 2**30:.3f} GiB, predictions {preds}; launches over "
          f"{forwards} forward passes {counts}; on {card}", flush=True)
    return counts, pair, sd, logits.cpu()


def _swin_direct(cfg, sd, attn_route=None, **kw):
    """The Swin of ``cfg`` built directly, for the dropout rates that the
    configuration has no field for."""
    from vitta_tpu_torch.models.swin import Recognizer3D
    mc = cfg.model
    model = Recognizer3D(mc.num_classes, patch_size=mc.patch_size,
                         window_size=mc.window_size, embed_dim=mc.embed_dim,
                         depths=mc.depths, num_heads=mc.num_heads,
                         attn_route=attn_route, **kw)
    model.load_state_dict(sd, strict=True)
    return model


def phase_swin_adapt_small(cfg, seed, t, hw, attn_route=None,
                           what="swin adapt small slice", cossim=False):
    """Two tta_online steps of a small Swin on the card and on the CPU,
    drop-path and head dropout 0; with ``cossim`` under
    ``stat_reg="cossim"``, the relation-map targets from
    ``compute_cossim_statistics`` of one clean batch.

    Tolerances as in ``phase_small_slice``: losses rtol 1e-3 / atol 1e-5,
    eval logits rtol 2e-3 / atol 2e-4, the EMA rtol 1e-3 / atol 1e-5; lr is
    raised to 1e-3 so that the updates stand far above float32 rounding,
    and each parameter's update agrees to 2% of its norm."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.precompute import (compute_cossim_statistics,
                                                  compute_source_statistics)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr=1e-3))
    kw = {}
    if cossim:
        cfg = cfg.replace(tta=dataclasses.replace(
            cfg.tta, stat_reg="cossim", stat_type=("temp",)))
        kw = dict(stat_types=cfg.tta.tap_stat_types())
    sd = _swin_weights(cfg, seed)
    rng = np.random.default_rng(seed)
    batches = _normalized_batches(rng, cfg, (2,), t, hw)
    if cossim:
        # every norm layer relates its t / 2 token planes in time
        src = compute_cossim_statistics(
            _swin_model(cfg, sd), batches, clip_len=t, device="cpu",
            tap_filter=lambda n: "patch_embed" not in n)
    else:
        src = compute_source_statistics(_swin_model(cfg, sd), batches,
                                        device="cpu")
    videos = _videos(rng, 2, t, hw)
    _reset_swin_counts()
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = VittaEngine(_swin_direct(cfg, sd, attn_route,
                                       drop_path_rate=0.0, head_dropout=0.0,
                                       **kw),
                          cfg, sd, src, device=dev)
        state = eng.init_state()
        metrics = []
        for views, clip, label in videos:
            state, m = eng.adapt_eval_step(state, views, clip, label)
            metrics.append({f: float(getattr(m, f))
                            for f in ("loss_reg", "loss_consis", "loss_ce")})
        runs[dev] = (metrics, eng.eval_logits(videos[-1][1]).cpu(),
                     {k: p.detach().cpu()
                      for k, p in eng.model.named_parameters()},
                     {k: (v.mean.cpu(), v.var.cpu())
                      for k, v in state.ema.items()})
    counts = _swin_counts()
    (m_gpu, l_gpu, p_gpu, e_gpu), (m_cpu, l_cpu, p_cpu, e_cpu) = (
        runs["cuda"], runs["cpu"])
    for i, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for f in a:
            if not abs(a[f] - b[f]) <= 1e-5 + 1e-3 * abs(b[f]):
                raise AssertionError(f"step {i} {f}: card {a[f]} cpu {b[f]}")
    logit_err = check_close("swin adapt eval logits", l_gpu, l_cpu, 2e-3, 2e-4)
    ema_err = max(check_close(f"swin adapt ema {k}", g, c, 1e-3, 1e-5)
                  for k in e_cpu for g, c in zip(e_gpu[k], e_cpu[k]))
    worst, moved = 0.0, 0
    for k, p in p_cpu.items():
        dg, dc = p_gpu[k] - sd[k], p - sd[k]
        diff, norm = float((dg - dc).norm()), float(dc.norm())
        if diff > 2e-2 * norm + 1e-8:
            raise AssertionError(f"update of {k}: card and cpu differ by "
                                 f"{diff / (norm + 1e-12):.3e} of its norm")
        worst = max(worst, diff / (norm + 1e-12))
        moved += norm > 0
    if moved != len(p_cpu):
        raise AssertionError(f"only {moved} of {len(p_cpu)} parameters moved")
    fwd, bwd = swin_launches(attn_route, cfg.model.embed_dim,
                             cfg.model.depths)
    for k, n in {**fwd, **bwd}.items():
        if n and counts[k] == 0:
            raise AssertionError(f"{what}: the {k} kernel was never launched")
    print(f"{what} ({attn_route or 'packed'}) card vs cpu: "
          f"losses {m_gpu} vs {m_cpu}; "
          f"eval logits max abs err {logit_err:.2e}; EMA max abs err "
          f"{ema_err:.2e}; all {moved} parameters moved, worst update "
          f"difference {worst:.2e} of its norm; launches {counts}",
          flush=True)


def phase_swin_adapt_full(cfg, sd, stats, seed, card, attn_route=None,
                          n_videos=SWIN_ADAPT_VIDEOS, warmup=2,
                          what="swin-B"):
    """tta_stream of the Swin of ``cfg`` (swin_ucf101_preset, at Swin-B's
    or Swin-T's width and depth) under ``attn_route`` over seeded videos,
    drop-path 0.2 and head dropout 0.5 on; returns the launch counts of
    the run and a summary of its times."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import tta_stream
    from vitta_tpu_torch.models import get_model
    classes = cfg.model.num_classes
    route = attn_route or "packed"
    t, hw = cfg.data.clip_length, cfg.data.input_size
    engine = VittaEngine(get_model(cfg, attn_route=attn_route), cfg, sd,
                         stats)
    if (engine.model.backbone.layers[2].blocks[-1].drop_path <= 0
            or engine.model.cls_head.dropout != 0.5):
        raise AssertionError("drop-path or head dropout is off")
    rng = np.random.default_rng(seed + 1)
    videos = _videos(rng, n_videos, t, hw)
    writer = _StepTimes()
    preds = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_swin_counts()
    top1, state, meters = tta_stream(engine, videos, seed=seed,
                                     metrics_writer=writer)
    torch.cuda.synchronize()
    counts = _swin_counts()
    peak = torch.cuda.max_memory_allocated()

    for k in ("loss_reg", "loss_consis", "loss_ce"):
        if not np.isfinite(meters[k].avg):
            raise AssertionError(f"{k} is not finite: {meters[k].avg}")
    if state.step != n_videos:
        raise AssertionError(f"{state.step} steps for {n_videos} videos")
    _reset_swin_counts()
    for clip in (videos[0][1], videos[-1][1]):
        logits = engine.eval_logits(clip)
        pred = int(torch.argmax(logits, -1)[0])
        if (tuple(logits.shape) != (1, classes) or not 0 <= pred < classes
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError("eval logits after adaptation are not "
                                 f"finite (1, {classes})")
        preds.append(pred)
    if _swin_counts()["contiguity_copies"]:
        raise AssertionError(f"{what} {route}: contiguity copies in a "
                             "forward pass")
    # every parameter has a finite gradient from the last step; a block
    # whose branch drop-path dropped for both views has an exactly zero one,
    # and at lr 1e-5 an update below float32's spacing leaves a tensor as it
    # was, so "most" is asked for and the counts are printed
    params = dict(engine.model.named_parameters())
    for k, p in params.items():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()) \
                or not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{k}: no finite gradient or value after "
                                 "adaptation")
    moved = sum(not torch.equal(p.detach(), engine.init_params[k])
                for k, p in params.items())
    tables = [k for k in params if k.endswith("relative_position_bias_table")]
    tables_grad = sum(bool(params[k].grad.abs().max() > 0) for k in tables)
    if 4 * moved < 3 * len(params) or 4 * tables_grad < 3 * len(tables):
        raise AssertionError(
            f"{moved} of {len(params)} parameters moved and {tables_grad} of "
            f"{len(tables)} bias tables have a gradient: fewer than three in "
            "four")
    ema_norm = sum(float(s.mean.abs().sum() + s.var.abs().sum())
                   for s in state.ema.values())
    if not (np.isfinite(ema_norm) and ema_norm > 0):
        raise AssertionError(f"EMA did not move (sum |ema| = {ema_norm})")
    # per video: the adapt forward and the eval forward, one backward
    fwd, bwd = swin_launches(attn_route, cfg.model.embed_dim,
                             cfg.model.depths)
    for k, per_pass in fwd.items():
        if counts[k] != 2 * per_pass * n_videos:
            raise AssertionError(f"{what} {route} {k}: {counts[k]} launches "
                                 f"over {n_videos} videos, expected 2 x "
                                 f"{per_pass} each")
    for k, per_pass in bwd.items():
        if counts[k] != per_pass * n_videos:
            raise AssertionError(f"{what} {route} {k}: {counts[k]} launches "
                                 f"over {n_videos} videos, expected {per_pass} "
                                 "each")
    warm = writer.ms[warmup:]
    summary = {"model": what, "route": route, "videos": len(warm),
               "median_ms": statistics.median(warm), "min_ms": min(warm),
               "max_ms": max(warm), "peak_gib": peak / 2**30}
    print(f"{what} adapt full slice ({route}): {n_videos} videos, median "
          f"{statistics.median(warm):.3f} ms/video (min {min(warm):.3f}, max "
          f"{max(warm):.3f}) after {len(writer.ms) - len(warm)} warm-up (host "
          f"clock, synchronised on the metrics; includes the uint8 "
          f"host-to-device copy), peak memory {peak / 2**30:.3f} GiB, "
          f"{moved} of {len(params)} parameter tensors moved, {tables_grad} "
          f"of {len(tables)} bias tables with a gradient in the last step, "
          f"losses reg {meters['loss_reg'].avg:.5f} consis "
          f"{meters['loss_consis'].avg:.5f} ce {meters['loss_ce'].avg:.5f}, "
          f"top1 {top1[0]:.1f}, predictions {preds}; launches {counts} "
          f"({counts['contiguity_copies'] / n_videos:.1f} contiguity copies "
          f"per video); on {card}", flush=True)

    # where the time goes: one adapt+eval step with its inputs on the card
    views, clip, label = (torch.from_numpy(a).cuda() for a in videos[-1])
    box = [state]

    def step():
        box[0], _m = engine.adapt_eval_step(box[0], views, clip, label)

    host_ms, busy, rows = device_breakdown(step, top=14)
    if busy == 0:
        print(f"{what} adapt step ({route}): device time not measured",
              flush=True)
    else:
        summary.update(host_ms=host_ms, device_busy_ms=busy,
                       idle_share=max(0.0, 1 - busy / host_ms))
        print(f"{what} adapt step ({route}), profiled: host {host_ms:.3f} ms, "
              f"device busy {busy:.3f} ms, idle share "
              f"{summary['idle_share']:.2f}; largest kernels: "
              + "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for k, ms, n in rows),
              flush=True)
    return counts, summary


def phase_routes_interleaved(cfg, sd, stats, seed, card, dtype="float32"):
    """One adapt+eval step of the Swin of ``cfg`` under packed, proj and
    ln_proj in turns (packed, proj, ln_proj, ln_proj, proj, packed), one
    engine per route built once and warmed up, on one seeded video with its
    inputs on the card: device busy of each step (torch.profiler) and its
    peak memory above what the engines hold between steps, the memory a
    route's activations and kept tensors take.  Phase 38 runs it at
    ``dtype`` bfloat16 (``Recognizer3D(..., dtype="bfloat16")``).  Returns
    {route: {"busy": [ms], "peak": [GiB]}}."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.models import get_model
    t, hw = cfg.data.clip_length, cfg.data.input_size
    views, clip, label = (torch.from_numpy(a).cuda() for a in
                          _videos(np.random.default_rng(seed + 2), 1, t,
                                  hw)[0])
    routes = ("packed", "proj", "ln_proj")
    engines = {r: VittaEngine(get_model(cfg, attn_route=r)
                              if dtype == "float32" else
                              _synthetic_swin(cfg, dtype, attn_route=r),
                              cfg, sd, stats)
               for r in routes}
    states = {r: e.init_state() for r, e in engines.items()}
    out = {r: {"busy": [], "peak": []} for r in routes}
    for route in routes + routes[::-1]:
        def step():
            states[route], _m = engines[route].adapt_eval_step(
                states[route], views, clip, label)
        step()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        out[route]["peak"].append(
            (torch.cuda.max_memory_allocated() - before) / 2**30)
        _host, busy, _rows = device_breakdown(step, top=None)
        out[route]["busy"].append(busy if busy > 0 else None)
    for route, r in out.items():
        print(f"swin-B adapt step, interleaved, route {route}"
              f"{', bfloat16' if dtype == 'bfloat16' else ''}: device busy "
              + ", ".join(fmt(b) for b in r["busy"]) + " ms, step peak "
              "above the engines' memory "
              + ", ".join(f"{p:.3f}" for p in r["peak"]) + f" GiB; on {card}",
              flush=True)
    del engines, states
    return out


# ---------------------------------------------------------------------------
# Video Swin-B at bfloat16 (phases 25-28)

def _bf16_swin_launches(names, parts=("ln_rows", "ln_bwd_kernel",
                                       "gemm_tiles", "attn_fwd",
                                       "attn_bwd")):
    """Raise where a float32 instance of the Swin kernels ran among
    ``names`` (the libraries' counts of a bfloat16 run)."""
    bad = {k: n for k, n in names.items()
           if any(k.startswith(p) for p in parts) and not _bf16_name(k)}
    if bad:
        raise AssertionError(f"float32 Swin kernels ran at bfloat16: {bad}")


_SIDE_STREAM = []


def graph_ms(fn, calls: int = 5, reps: int = 3) -> float:
    """Device ms per call of ``fn`` from CUDA events around the replay of a
    CUDA graph of ``calls`` calls (median of ``reps`` replays): the kernels
    back to back, no host in between, and no profiler, whose traces drop
    kernels after many profiles in one process (phase 25 saw device times
    below the bytes' bound).  ``fn`` runs once on a side stream first, as
    capture asks: one stream for every call, since torch keeps a cuBLAS
    workspace for each stream a product ran on, which would stand in the
    later phases' peak memory."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def _measure_bf16(fn):
    """(CUDA-event ms of one call, device ms a call from a CUDA graph's
    replay) of ``fn``."""
    return cuda_ms(fn, reps=6), graph_ms(fn)


def _measure_bf16_grad(backward):
    """The same for a library call's autograd backward, which a CUDA graph
    does not take from outside its forward: event ms, and device ms from
    the profiler (asked again, twice at most, where it recorded no kernel;
    where it drops kernels it reads low, in the library's favour)."""
    with torch.enable_grad():
        event = cuda_ms(backward, reps=6)
        device = None
        for _ in range(3):
            device = device_ms(backward, reps=4)
            if device is not None:
                break
    return event, device


def sdpa_backend(leaves, mask, scale) -> str:
    """The backend torch's dispatcher picks for scaled_dot_product_attention
    on these inputs (its own choice function), or "unknown"."""
    try:
        from torch.nn.attention import SDPBackend
        choice = torch._fused_sdp_choice(*leaves, mask, 0.0, False,
                                         scale=scale)
        return SDPBackend(choice).name
    except Exception as exc:       # an internal function: name what failed
        return f"unknown ({type(exc).__name__})"


def per_site(t, sizes):
    """One line: each bfloat16 kernel's device us a call beside its bound
    at bfloat16 and its launches a call; ``sizes`` is {label: (time key,
    bytes, operations, launches)}."""
    print("  " + "; ".join(
        f"{label} device us {fmt(t[key][1] and t[key][1] * 1e3)} against "
        f"its bound {bound(nb, fl, BF16_FLOP_PER_S)[0] * 1e3:.2f} us, "
        f"{n} launches a call"
        for label, (key, nb, fl, n) in sizes.items()), flush=True)


def ln_bwd_one_launch(what, x, g, dy):
    """The bfloat16 LayerNorm backward on (x, g, dy): one launch of an
    ln_bwd_bf16x8 instance (the library's own counts), its plan the
    mirror's (``cuda_ln.ln_bwd_bf16_plan`` at the clusters the card holds),
    repeats, another stream and CUDA graph replays bit-equal."""
    from vitta_tpu_torch.ops import cuda_ln as cl
    names = launches_of(lambda: cl.ln_bwd_cuda(x, g, dy, 1e-5))
    if len(names) != 1 or not next(iter(names)).startswith("ln_bwd_bf16x8<"):
        raise AssertionError(f"{what}: launches {names}, expected one "
                             "ln_bwd_bf16x8")
    plan = cl.ln_bwd_bf16_plan_cuda(*x.shape)
    mirror = cl.ln_bwd_bf16_plan(*x.shape, plan["resident"], plan["sms"])
    if {k: plan[k] for k in mirror} != mirror:
        raise AssertionError(f"{what}: the kernel's plan {plan} is not "
                             f"ln_bwd_bf16_plan's {mirror}")
    one_launch_and_graph(f"{what} bwd", lambda: cl.ln_bwd_cuda(x, g, dy, 1e-5),
                         next(iter(names)))


def ln_fwd_one_launch(what, x, g, b):
    """The bfloat16 LayerNorm forward on (x, g, b): one launch of the
    ln_fwd_bf16x8 instance its plan names (the library's own counts), the
    plan the mirror's (``cuda_ln.ln_fwd_bf16_plan`` at the blocks an SM
    holds), repeats, another stream and CUDA graph replays bit-equal."""
    from vitta_tpu_torch.ops import cuda_ln as cl
    plan = cl.ln_fwd_bf16_plan_cuda(*x.shape)
    mirror = cl.ln_fwd_bf16_plan(*x.shape, plan["per_sm"], plan["sms"])
    if {k: plan[k] for k in mirror} != mirror:
        raise AssertionError(f"{what}: the kernel's plan {plan} is not "
                             f"ln_fwd_bf16_plan's {mirror}")
    one_launch_and_graph(f"{what} fwd", lambda: (cl.ln_fwd_cuda(
        x, g, b, 1e-5),), f"ln_fwd_bf16x8<{plan['units']}, {plan['lanes']}>")


def phase_bf16_swin_kernels(dev):
    """Phase 25: the bfloat16 LayerNorm, LayerNorm-MLP and packed attention
    kernels (rows 3, 4, 10, 11, 14, 15 in the bfloat16 Swin) against their
    plain versions at every Swin-B stage shape, forward at 1 and 2 clips,
    backward at 2 clips (the attention's also at 1 clip), held by
    vitta_tpu_torch/tools/bf16_checks.py: every bfloat16 output within one
    bfloat16 ulp of the plain version computed from the kernel's own
    rounded intermediates (the LayerNorm-MLP's a, dh, dhc and dy; the
    attention's e from its instances that write it, and dl from the
    backward's scratch), those intermediates within one ulp (e) or the
    float32 tolerance (dl, dh, dy) of their plain values, the attention's
    out and dqkv end to end at most 1e-4 of the values beyond one ulp and
    those within 2^-7 of the absolute products through e and dl; float32
    outputs (dgamma, dbeta, ms, dbias) within the float32 phases'
    tolerances; two backward runs bit-equal; launches per call from the
    libraries' counts, every one a bfloat16 instance; the LayerNorm forward
    at every Swin-B and Swin-T site at 1 and 2 clips one launch of the
    16-byte form its plan (the mirror's) names, bit-equal over repeats,
    another stream and graph replays, with device us beside the bound and
    F.layer_norm's per Swin-T site and pass; a LayerNorm view 2
    bytes past a 16-byte boundary on the one-value path.  Each row's
    ``max_abs_err`` is the largest difference of any of its outputs from
    the plain version it is held to.  Device ms per Swin-B pass of 2 clips
    (CUDA graphs' replays, ``graph_ms``) beside the bound at bfloat16
    (bytes over 3.35 TB/s, operations over the dense bfloat16 tensor-core
    rate), the float32 kernel's on the same values by the same replays
    (``float32_device_ms``), the plain versions', the library calls'
    (F.layer_norm, sdpa with the bias as attn_mask, their backward from
    the profiler, sdpa's with the bias's gradient too for row 15; the
    LayerNorm-MLP has none, its F.layer_norm-F.linear-F.gelu-F.linear
    composition is timed beside it).  The attention rows are timed on the
    compact bias, the form the bfloat16 model hands them, with the dense
    form's device ms beside them (``dense_bias_device_ms``); the compact
    forward must give the dense one's row maxima and e to the bit, its
    sums within ATTN_TOL and out within one ulp, the compact dbias the
    kernel's own dl collapsed per window in window order.  Returns the six JSON
    rows."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops import cuda_bias as cb
    from vitta_tpu_torch.ops import cuda_ln as cl
    from vitta_tpu_torch.ops import cuda_mlp as cm
    from vitta_tpu_torch.tools.bf16_checks import (
        assert_bf16_mostly_within, assert_bf16_within, ln_mlp_bwd_stages,
        ln_mlp_fwd_stages, packed_attention_bf16_bwd_stages,
        packed_attention_bf16_fwd_stage, packed_attention_bf16_intermediates,
        packed_attention_bf16_slack)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def bf(*shape, scale=1.0):
        return randn(*shape, scale=scale).to(bf16)

    def kernels(fn, want):
        names = launches_of(fn)
        _bf16_swin_launches(names)
        if sum(names.values()) != want:
            raise AssertionError(f"launches {names}, expected {want}")
        return names

    wgmma = {"mlp_fwd": {}, "mlp_bwd": {}}

    def mlp_kernels(key, fn, want, products):
        """kernels(), and the LayerNorm-MLP's products all on the wgmma
        core (gemm_wgmma_bf16), none on gemm_tiles."""
        names = kernels(fn, want)
        wg = {k: n for k, n in names.items()
              if k.startswith("gemm_wgmma_bf16")}
        if (sum(wg.values()) != products
                or any(k.startswith("gemm_tiles") for k in names)):
            raise AssertionError(f"launches {names}: expected {products} of "
                                 "gemm_wgmma_bf16 and none of gemm_tiles")
        for k, n in wg.items():
            wgmma[key][k] = wgmma[key].get(k, 0) + n
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    tot = {k: Totals() for k in ("ln_fwd", "ln_bwd", "attn_fwd", "attn_bwd",
                                 "mlp_fwd", "mlp_bwd")}

    comp = {"mlp_fwd": 0.0, "mlp_bwd": 0.0}
    f32 = {k: 0.0 for k in tot}     # the float32 kernels' device ms a pass
    # the bfloat16 attention on the dense bias, and sdpa's backward without
    # the bias's gradient, device ms a pass
    dense_ms = {"attn_fwd": 0.0, "attn_bwd": 0.0}
    no_dbias = 0.0
    apart = {}

    def note(key, row, result):
        """Keep an output's share of values that differ, its largest
        difference in units of its bound and (end to end) share beyond one
        ulp, and its largest absolute difference in ``row``'s
        max_abs_err."""
        share, ulps, err = result[:3]
        s0, u0, b0 = apart.get(key, (0.0, 0.0, 0.0))
        apart[key] = (max(s0, share), max(u0, ulps),
                      max(b0, result[3] if len(result) > 3 else 0.0))
        tot[row].err = max(tot[row].err, err)

    def scaled(row, *args):
        tot[row].err = max(tot[row].err, check_scaled(*args))

    def add_f32(key, sites, fn):
        """The float32 kernel on the same values, by the same replays."""
        ms_ = graph_ms(fn)
        f32[key] = None if f32[key] is None or ms_ is None else (
            f32[key] + sites * ms_)

    # rows 3 and 4: every LayerNorm site
    for (tokens, c), sites in SWIN_LN_SITES.items():
        g, b = randn(c), randn(c)
        gb, bb = g.to(bf16), b.to(bf16)
        for clips in (1, 2):
            x = (randn(clips * tokens, c, scale=2.0) + 0.5).to(bf16)
            what = f"ln bf16 rows={clips * tokens} C={c}"
            ln_fwd_one_launch(what, x, g, b)
            note("y", "ln_fwd", assert_bf16_within(
                f"{what} y", cl.ln_fwd_cuda(x, g, b, 1e-5),
                cl.layer_norm_reference(x, g, b, 1e-5)))
            if clips == 1:
                continue
            dy = bf(clips * tokens, c)
            ln_bwd_one_launch(what, x, g, dy)
            got = cl.ln_bwd_cuda(x, g, dy, 1e-5)
            again = cl.ln_bwd_cuda(x, g, dy, 1e-5)
            want = cl.layer_norm_backward_reference(x, g, dy, 1e-5)
            if not all(torch.equal(p, q) for p, q in zip(got, again)):
                raise AssertionError(f"{what}: two backward runs differ")
            note("dx", "ln_bwd", assert_bf16_within(f"{what} dx", got[0],
                                                    want[0]))
            for nm, p, q in zip(("dgamma", "dbeta"), got[1:], want[1:]):
                scaled("ln_bwd", f"{what} {nm}", p, q, LN_BWD_TOL)
            err = tot["ln_bwd"].err
            xl = x.detach().requires_grad_()
            gl, bl = gb.detach().requires_grad_(), bb.detach().requires_grad_()
            yl = F.layer_norm(xl, (c,), gl, bl, 1e-5)
            t = {"kernel": _measure_bf16(
                     lambda: cl.ln_fwd_cuda(x, g, b, 1e-5)),
                 "plain": _measure_bf16(lambda: cl.layer_norm_reference(
                     x, g, b, 1e-5)),
                 "F.layer_norm": _measure_bf16(lambda: F.layer_norm(
                     x, (c,), gb, bb, 1e-5)),
                 "kernel bwd": _measure_bf16(lambda: cl.ln_bwd_cuda(
                     x, g, dy, 1e-5)),
                 "plain bwd": _measure_bf16(
                     lambda: cl.layer_norm_backward_reference(x, g, dy, 1e-5)),
                 "F.layer_norm bwd": _measure_bf16_grad(
                     lambda: torch.autograd.grad(yl, (xl, gl, bl), dy,
                                                 retain_graph=True))}
            _report(f"{what} ({sites} sites)", err, t)
            xf, dyf = x.float(), dy.float()
            add_f32("ln_fwd", sites, lambda: cl.ln_fwd_cuda(xf, g, b, 1e-5))
            add_f32("ln_bwd", sites, lambda: cl.ln_bwd_cuda(xf, g, dyf, 1e-5))
            del xf, dyf
            nel = x.numel()
            per_site(t, {"fwd": ("kernel", 2 * nel * 2 + 2 * c * 4, 8 * nel,
                                 1),
                         "bwd": ("kernel bwd", 3 * nel * 2 + 3 * c * 4,
                                 12 * nel, 1)})
            tot["ln_fwd"].add(sites, ms=t["kernel"][0],
                              device_ms=t["kernel"][1],
                              plain_ms=t["plain"][0],
                              plain_device_ms=t["plain"][1],
                              library_ms=t["F.layer_norm"][0],
                              library_device_ms=t["F.layer_norm"][1],
                              bytes=2 * nel * 2 + 2 * c * 4, flops=8 * nel)
            tot["ln_bwd"].add(sites, ms=t["kernel bwd"][0],
                              device_ms=t["kernel bwd"][1],
                              plain_ms=t["plain bwd"][0],
                              plain_device_ms=t["plain bwd"][1],
                              library_ms=t["F.layer_norm bwd"][0],
                              library_device_ms=t["F.layer_norm bwd"][1],
                              bytes=3 * nel * 2 + 3 * c * 4, flops=12 * nel)
            del x, dy, got, again, want, xl, yl
    # the forward at every Swin-T site (1 and 2 clips): values, one launch
    # of the 16-byte form, its plan, repeats and graph replays bit-equal,
    # device us beside the bound, F.layer_norm's beside it, per pass
    f_pass = {1: [0.0, 0.0, 0.0], 2: [0.0, 0.0, 0.0]}
    for (tokens, c), sites in SWIN_T_LN_SITES.items():
        g, b = randn(c), randn(c)
        gb, bb = g.to(bf16), b.to(bf16)
        for clips in (1, 2):
            rows = clips * tokens
            x = (randn(rows, c, scale=2.0) + 0.5).to(bf16)
            what = f"ln bf16 swin-T rows={rows} C={c}"
            ln_fwd_one_launch(what, x, g, b)
            note("y", "ln_fwd", assert_bf16_within(
                f"{what} y", cl.ln_fwd_cuda(x, g, b, 1e-5),
                cl.layer_norm_reference(x, g, b, 1e-5)))
            dev_ms = graph_ms(lambda: cl.ln_fwd_cuda(x, g, b, 1e-5))
            lib_ms = graph_ms(lambda: F.layer_norm(x, (c,), gb, bb, 1e-5))
            nb = 2 * x.numel() * 2 + 2 * c * 4
            acc = f_pass[clips]
            acc[0] = None if dev_ms is None or acc[0] is None \
                else acc[0] + sites * dev_ms
            acc[1] = None if lib_ms is None or acc[1] is None \
                else acc[1] + sites * lib_ms
            acc[2] += sites * bound(nb, 0)[0]
            print(f"{what} fwd ({sites} sites): device us "
                  f"{fmt(dev_ms and dev_ms * 1e3)} against its bound "
                  f"{bound(nb, 0)[0] * 1e3:.2f} us, F.layer_norm "
                  f"{fmt(lib_ms and lib_ms * 1e3)}", flush=True)
            del x
    for clips, (dv, lb, bd) in f_pass.items():
        print(f"ln_fwd_bf16 per Swin-T pass of {clips} clip(s): device ms "
              f"{fmt(dv)}, F.layer_norm {fmt(lb)}, bound {bd:.4f} ms by "
              "bytes at bfloat16", flush=True)
    # the standalone backward at every Swin-T site too (2 clips): values,
    # one launch, its plan, repeats and graph replays bit-equal, device ms
    t_pass, t_bound = 0.0, 0.0
    for (tokens, c), sites in SWIN_T_LN_SITES.items():
        rows = 2 * tokens
        x = (randn(rows, c, scale=2.0) + 0.5).to(bf16)
        g, dy = randn(c), bf(rows, c)
        what = f"ln bf16 swin-T rows={rows} C={c}"
        ln_bwd_one_launch(what, x, g, dy)
        got = cl.ln_bwd_cuda(x, g, dy, 1e-5)
        want = cl.layer_norm_backward_reference(x, g, dy, 1e-5)
        note("dx", "ln_bwd", assert_bf16_within(f"{what} dx", got[0],
                                                want[0]))
        for nm, p, q in zip(("dgamma", "dbeta"), got[1:], want[1:]):
            scaled("ln_bwd", f"{what} {nm}", p, q, LN_BWD_TOL)
        dev_ms = graph_ms(lambda: cl.ln_bwd_cuda(x, g, dy, 1e-5))
        nbytes = 3 * x.numel() * 2 + 3 * c * 4
        t_pass = None if dev_ms is None or t_pass is None \
            else t_pass + sites * dev_ms
        t_bound += sites * bound(nbytes, 0)[0]
        print(f"{what} ({sites} sites): device us {fmt(dev_ms and dev_ms * 1e3)}"
              f" against its bound {bound(nbytes, 0)[0] * 1e3:.2f} us",
              flush=True)
        del x, dy, got, want
    print(f"ln_bwd_bf16 per Swin-T pass of 2 clips: device ms {fmt(t_pass)}, "
          f"bound {t_bound:.4f} ms by bytes at bfloat16", flush=True)
    # a view 2 bytes off a 16-byte boundary: the one-value paths
    x = (randn(6272, 256, scale=2.0) + 0.5).to(bf16)
    dy, g, b = bf(6272, 256), randn(256), randn(256)
    buf = torch.empty(x.numel() + 1, dtype=bf16, device=dev)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    names = {**launches_of(lambda: cl.ln_fwd_cuda(xs, g, b, 1e-5)),
             **launches_of(lambda: cl.ln_bwd_cuda(xs, g, dy, 1e-5))}
    if "ln_rows_any<__nv_bfloat16>" not in names or not any(
            k.startswith("ln_bwd_kernel<false") for k in names):
        raise AssertionError(f"ln bf16 unaligned view: launches {names}")
    assert_bf16_within("ln bf16 unaligned view y",
                       cl.ln_fwd_cuda(xs, g, b, 1e-5),
                       cl.layer_norm_reference(x, g, b, 1e-5))
    assert_bf16_within("ln bf16 unaligned view dx",
                       cl.ln_bwd_cuda(xs, g, dy, 1e-5)[0],
                       cl.layer_norm_backward_reference(x, g, dy, 1e-5)[0])
    print(f"ln bf16, a view 2 bytes past a 16-byte boundary (6272 x 256): "
          f"launches {names}, y and dx within one ulp", flush=True)
    del x, xs, buf, dy

    # rows 14 and 15: the packed attention at every stage.  The model's
    # path hands the bfloat16 kernels the compact bias (models/swin.py);
    # the rows' times are that form's, the dense form's beside them
    wd, wh, ww = SWIN_WINDOW
    n_tok = wd * wh * ww
    for c, nh, tokens, nw, depth in SWIN_STAGES:
        hd, scale = c // nh, (c // nh) ** -0.5
        vc = randn(nh, 2 * wd - 1, wh * ww, wh * ww, scale=0.5)
        dense = cb.expand_bias_reference(vc, wd)
        mask = None
        if nw > 1:
            mask = torch.where(torch.rand(nw, n_tok, n_tok, device=dev,
                                          generator=gen) < 0.3, -100.0, 0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
        for clips in (1, 2):
            b_ = clips * tokens // n_tok
            split = ca.bwd_split(b_, nh, dev)
            qkv, g = bf(b_, n_tok, 3 * c), bf(b_, n_tok, c)
            for m in ((None, mask) if mask is not None else (None,)):
                what = (f"attention bf16 B_={b_} nh={nh} hd={hd} mask="
                        f"{m is not None}")
                out, ms_ = ca.attn_packed_fwd_cuda(qkv, dense, m, scale, nh,
                                                   save_ms=True)
                want, want_ms = ca.packed_attention_bf16_reference(
                    qkv, dense, m, scale, nh, save_ms=True)
                tot["attn_fwd"].err = max(tot["attn_fwd"].err, check_close(
                    f"{what} row max/sum", ms_, want_ms, ATTN_TOL))
                # the steps on the kernel's own e and dl, and those against
                # their plain values
                tf = {}
                out_t, ms_t = ca.attn_packed_fwd_cuda(
                    qkv, dense, m, scale, nh, save_ms=True, taps=tf)
                if not (torch.equal(out_t, out) and torch.equal(ms_t, ms_)):
                    raise AssertionError(f"{what}: the tapped forward differs")
                # the compact bias's kernel forms the same logits (strips of
                # other rows) and sums s and o in another order than the
                # dense one's: the same row maxima and e to the bit, s
                # within float32's reordering, out within one ulp
                tc = {}
                out_c, ms_c = ca.attn_packed_fwd_cuda(qkv, vc, m, scale, nh,
                                                      save_ms=True, taps=tc)
                if not (torch.equal(ms_c[..., 0::2], ms_[..., 0::2])
                        and torch.equal(tc["e"], tf["e"])):
                    raise AssertionError(f"{what}: the compact bias's row "
                                         "maxima or e differ from the dense's")
                check_close(f"{what} compact against dense row sums",
                            ms_c[..., 1::2], ms_[..., 1::2], ATTN_TOL)
                assert_bf16_within(f"{what} compact against dense out", out_c,
                                   out)
                del tc
                e_want, dl_want = packed_attention_bf16_intermediates(
                    qkv, dense, m, ms_, g, scale, nh)
                note("e (forward)", "attn_fwd", assert_bf16_within(
                    f"{what} forward e", tf["e"], e_want))
                note("out from its e", "attn_fwd", assert_bf16_within(
                    f"{what} out from the kernel's e", out,
                    packed_attention_bf16_fwd_stage(qkv, ms_, tf["e"], nh)))
                del tf, out_t, ms_t
                s_out, s_dqkv = packed_attention_bf16_slack(
                    qkv, dense, m, ms_, g, scale, nh)
                note("out", "attn_fwd", assert_bf16_mostly_within(
                    f"{what} out", out, want, s_out))
                # the compact bias's forward against the plain version too,
                # on its own row sums' slack
                tot["attn_fwd"].err = max(tot["attn_fwd"].err, check_close(
                    f"{what} compact row max/sum", ms_c, want_ms, ATTN_TOL))
                s_out_c, _ = packed_attention_bf16_slack(
                    qkv, vc, m, ms_c, g, scale, nh)
                note("out", "attn_fwd", assert_bf16_mostly_within(
                    f"{what} compact out", out_c, want, s_out_c))
                del s_out, s_out_c, out_c, ms_c
                for bias_t in (dense, vc):
                    kernels(lambda: ca.attn_packed_fwd_cuda(qkv, bias_t, m,
                                                            scale, nh), 1)
                for form, bias_t in (("dense", dense), ("compact", vc)):
                    got = ca.attn_packed_bwd_cuda(qkv, bias_t, m, ms_, g,
                                                  scale, nh)
                    again = ca.attn_packed_bwd_cuda(qkv, bias_t, m, ms_, g,
                                                    scale, nh)
                    wq, wb = ca.packed_attention_bf16_backward_reference(
                        qkv, bias_t, m, ms_, g, scale, nh)
                    if not (torch.equal(got[0], again[0])
                            and torch.equal(got[1], again[1])):
                        raise AssertionError(f"{what} {form}: two backward "
                                             "runs differ")
                    tb = {}
                    tapped = ca.attn_packed_bwd_cuda(qkv, bias_t, m, ms_, g,
                                                     scale, nh, taps=tb)
                    if not (torch.equal(tapped[0], got[0])
                            and torch.equal(tapped[1], got[1])):
                        raise AssertionError(f"{what} {form}: the tapped "
                                             "backward differs")
                    note("e (backward)", "attn_bwd", assert_bf16_within(
                        f"{what} {form} backward e", tb["e"], e_want))
                    scaled("attn_bwd", f"{what} {form} dl", tb["dl"], dl_want,
                           ATTN_BWD_TOL)
                    note("dqkv from its e and dl", "attn_bwd",
                         assert_bf16_within(
                             f"{what} {form} dqkv from the kernel's e and dl",
                             got[0], packed_attention_bf16_bwd_stages(
                                 qkv, ms_, g, tb["e"], tb["dl"], scale, nh)))
                    note("dqkv", "attn_bwd", assert_bf16_mostly_within(
                        f"{what} {form} dqkv", got[0], wq, s_dqkv))
                    scaled("attn_bwd", f"{what} {form} dbias", got[1], wb,
                           ATTN_BWD_TOL)
                    # the kernel's compact partials or (dense) its dl,
                    # summed in window order on its own dl: the plain
                    # order's bits
                    if not torch.equal(got[1], ca.dbias_in_window_order(
                            tb["dl"], bias_t)):
                        raise AssertionError(
                            f"{what}: the {form} dbias is not the windows' "
                            "dl in window order")
                    names = kernels(lambda: ca.attn_packed_bwd_cuda(
                        qkv, bias_t, m, ms_, g, scale, nh), 2 + (split > 1))
                    reduce_ = ("dbias_windows_kernel" if form == "compact"
                               else ca.dense_dbias_reduce_kernel(n_tok, nh))
                    if names.get(reduce_) != 1:
                        raise AssertionError(f"{what} {form}: launches "
                                             f"{names}, no {reduce_}")
                    floats = ca.bwd_scratch_floats(
                        b_, n_tok, nh, hd, bf16, form == "compact", wd,
                        wh * ww, device=dev)
                    if form == "compact" and floats >= b_ * nh * n_tok ** 2:
                        raise AssertionError(f"{what}: the compact form's "
                                             f"scratch holds {floats} floats")
                    del got, again, wq, wb, tb, tapped
                del e_want, dl_want, s_dqkv
                err = max(tot["attn_fwd"].err, tot["attn_bwd"].err)
                if clips == 1:
                    print(f"{what}, {split} block(s) a problem: out and dqkv "
                          "within their bounds, two runs bit-equal, the "
                          "compact form's row maxima and e the dense "
                          "form's bits", flush=True)
                    continue
                q5 = qkv.reshape(b_, n_tok, 3, nh, hd).permute(2, 0, 3, 1, 4)
                leaves = [q5[i].detach().requires_grad_() for i in range(3)]
                am = (dense[None] if m is None else (
                    dense[None, None] + m[None, :, None]).expand(
                        b_ // nw, nw, nh, n_tok, n_tok).reshape(
                            b_, nh, n_tok, n_tok)).to(bf16)
                o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=am,
                                                       scale=scale)
                # sdpa with the bias's gradient too, row 15's like for like
                am_g = am.expand(b_, nh, n_tok, n_tok).contiguous(
                    ).requires_grad_()
                with torch.enable_grad():
                    o_lib_b = F.scaled_dot_product_attention(
                        *leaves, attn_mask=am_g, scale=scale)
                g4 = g.reshape(b_, n_tok, nh, hd).permute(0, 2, 1, 3)
                t = {"kernel": _measure_bf16(lambda: ca.attn_packed_fwd_cuda(
                         qkv, vc, m, scale, nh)),
                     "kernel dense": _measure_bf16(
                         lambda: ca.attn_packed_fwd_cuda(qkv, dense, m, scale,
                                                         nh)),
                     "plain": _measure_bf16(
                         lambda: ca.packed_attention_bf16_reference(
                             qkv, vc, m, scale, nh)),
                     "sdpa": _measure_bf16(
                         lambda: F.scaled_dot_product_attention(
                             q5[0], q5[1], q5[2], attn_mask=am, scale=scale)),
                     "kernel bwd": _measure_bf16(
                         lambda: ca.attn_packed_bwd_cuda(
                             qkv, vc, m, ms_, g, scale, nh)),
                     "kernel bwd dense": _measure_bf16(
                         lambda: ca.attn_packed_bwd_cuda(
                             qkv, dense, m, ms_, g, scale, nh)),
                     "plain bwd": _measure_bf16(
                         lambda: ca.packed_attention_bf16_backward_reference(
                             qkv, vc, m, ms_, g, scale, nh)),
                     "sdpa bwd": _measure_bf16_grad(
                         lambda: torch.autograd.grad(o_lib, leaves, g4,
                                                     retain_graph=True)),
                     "sdpa bwd with dbias": _measure_bf16_grad(
                         lambda: torch.autograd.grad(
                             o_lib_b, leaves + [am_g], g4,
                             retain_graph=True))}
                _report(f"{what}, {split} block(s) a problem", err, t)
                print(f"  sdpa's backend: {sdpa_backend(leaves, am_g, scale)}"
                      " (with the bias's gradient)", flush=True)
                # shifted blocks are every second one where there is a mask
                sites = depth // 2 if mask is not None else depth
                qf, gf = qkv.float(), g.float()
                _o32, ms32 = ca.attn_packed_fwd_cuda(qf, dense, m, scale, nh,
                                                     save_ms=True)
                add_f32("attn_fwd", sites, lambda: ca.attn_packed_fwd_cuda(
                    qf, dense, m, scale, nh))
                add_f32("attn_bwd", sites, lambda: ca.attn_packed_bwd_cuda(
                    qf, dense, m, ms32, gf, scale, nh))
                del qf, gf, _o32, ms32
                for key, tk in (("attn_fwd", "kernel dense"),
                                ("attn_bwd", "kernel bwd dense")):
                    dense_ms[key] = (None if dense_ms[key] is None
                                     or t[tk][1] is None
                                     else dense_ms[key] + sites * t[tk][1])
                dv = t["sdpa bwd"][1]
                no_dbias = (None if no_dbias is None or dv is None
                            else no_dbias + sites * dv)
                pairs = b_ * nh * n_tok * n_tok
                extra = vc.numel() * 4 + (0 if m is None else m.numel() * 4)
                per_site(t, {
                    "fwd": ("kernel", (qkv.numel() + out.numel()) * 2 + extra,
                            pairs * (4 * hd + 6), 1),
                    "bwd": ("kernel bwd", (2 * qkv.numel() + g.numel()) * 2
                            + ms_.numel() * 4 + vc.numel() * 4 + extra,
                            pairs * (10 * hd + 12), 2 + (split > 1))})
                tot["attn_fwd"].add(
                    sites, ms=t["kernel"][0], device_ms=t["kernel"][1],
                    plain_ms=t["plain"][0], plain_device_ms=t["plain"][1],
                    library_ms=t["sdpa"][0], library_device_ms=t["sdpa"][1],
                    bytes=(qkv.numel() + out.numel()) * 2 + extra,
                    flops=pairs * (4 * hd + 6))
                tot["attn_bwd"].add(
                    sites, ms=t["kernel bwd"][0],
                    device_ms=t["kernel bwd"][1],
                    plain_ms=t["plain bwd"][0],
                    plain_device_ms=t["plain bwd"][1],
                    library_ms=t["sdpa bwd with dbias"][0],
                    library_device_ms=t["sdpa bwd with dbias"][1],
                    bytes=(2 * qkv.numel() + g.numel()) * 2
                    + ms_.numel() * 4 + vc.numel() * 4 + extra,
                    flops=pairs * (10 * hd + 12))
                del leaves, am, o_lib, q5, am_g, o_lib_b
            del qkv, g, out, ms_, want

    # rows 10 and 11: the LayerNorm-MLP at every stage; the tap's cotangent
    # on y exists at the chosen blocks, stages 3 and 4
    names_b = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for stage, (c, _nh, tokens, _nw, depth) in enumerate(SWIN_STAGES):
        f = 4 * c
        gm, bt = 1 + 0.1 * randn(c), 0.1 * randn(c)
        w1, b1 = bf(f, c, scale=c ** -0.5), bf(f, scale=0.1)
        w2, b2 = bf(c, f, scale=f ** -0.5), bf(c, scale=0.1)
        for clips in (1, 2):
            m_rows = clips * tokens
            x = bf(m_rows, c, scale=1.5)
            args = (x, gm, bt, w1, b1, w2, b2, 1e-5)
            what = f"ln_mlp bf16 M={m_rows} C={c}"
            if (cm.bf16_gemm_plan_cuda(m_rows, c, f)
                    != cm.bf16_gemm_plan(m_rows, c, f, sms)):
                raise AssertionError(f"{what}: the library's plan is not "
                                     "cuda_mlp.bf16_gemm_plan")
            mlp_kernels("mlp_fwd", lambda: cm.ln_mlp_fwd_cuda(
                *args, save_residuals=True), 3, 2)
            got = cm.ln_mlp_fwd_cuda(*args, save_residuals=True)
            want = ln_mlp_fwd_stages(*args, got[1], got[2])
            for nm, p, q in zip(("o", "y", "a", "s"), got, want):
                note(f"mlp {nm}", "mlp_fwd",
                     assert_bf16_within(f"{what} {nm}", p, q))
            if clips == 1:
                del got, want, x, args
                continue
            _o, y, a, s_ = got
            go = bf(m_rows, c)
            gy = bf(m_rows, c, scale=0.1) if stage >= 2 else None
            scratch = torch.empty(cm.ln_mlp_bwd_scratch_floats(
                m_rows, c, f, bf16), dtype=torch.float32, device=dev)
            bargs = (x, y, a, s_, go, gy, gm, w1, w2, 1e-5)
            # 8 to 10 launches (12 on mma.sync): db1 is summed in the dh
            # product's epilogue (its column partials, then
            # reduce_partials), dw1 and dw2 share one launch, and a weight
            # gradient left in one chunk is rounded in its epilogue
            n_bwd = cm.bf16_bwd_launches(m_rows, c, f, sms)
            mlp_kernels("mlp_bwd", lambda: cm.ln_mlp_bwd_cuda(*bargs), n_bwd,
                        3)
            res = cm.ln_mlp_bwd_cuda(*bargs, scratch=scratch)
            dh, dhc, dyk = cm.bf16_bwd_scratch_views(scratch, m_rows, c, f)
            ref = ln_mlp_bwd_stages(*bargs, dh, dhc, dyk)
            again = cm.ln_mlp_bwd_cuda(*bargs)
            if not all(torch.equal(p, q) for p, q in zip(res, again)):
                raise AssertionError(f"{what}: two backward runs differ")
            if not torch.equal(dhc, ref["dhc"]):
                raise AssertionError(f"{what}: dh is not rounded once")
            # dh and dy are intermediates: checked, not counted as outputs
            for nm, dh_ in (("dh", dh), ("dy", dyk)):
                check_scaled(f"{what} {nm}", dh_, ref[nm], MLP_BWD_TOL)
            for nm, p in zip(names_b, res):
                if nm in ("dgamma", "dbeta"):
                    scaled("mlp_bwd", f"{what} {nm}", p, ref[nm], MLP_BWD_TOL)
                else:
                    note(f"mlp {nm}", "mlp_bwd", assert_bf16_within(
                        f"{what} {nm}", p, ref[nm]))
            err = tot["mlp_bwd"].err
            # the composition, at bfloat16, forward and autograd backward
            leaves = [t_.detach().requires_grad_()
                      for t_ in (x, gm.to(bf16), bt.to(bf16), w1, b1, w2, b2)]

            def composition(xi, gi, bi, w1i, b1i, w2i, b2i):
                yi = F.layer_norm(xi, (c,), gi, bi, 1e-5)
                return F.linear(F.gelu(F.linear(yi, w1i, b1i)), w2i, b2i), yi
            co, cy = composition(*leaves)
            cots = (go, gy) if gy is not None else (go,)
            outs = (co, cy) if gy is not None else (co,)
            t = {"kernel": _measure_bf16(lambda: cm.ln_mlp_fwd_cuda(*args)),
                 "plain": _measure_bf16(lambda: cm.ln_mlp_reference(*args)),
                 "composition": _measure_bf16(lambda: composition(*leaves)),
                 "kernel bwd": _measure_bf16(
                     lambda: cm.ln_mlp_bwd_cuda(*bargs)),
                 "plain bwd": _measure_bf16(
                     lambda: cm.ln_mlp_backward_reference(*bargs)),
                 "composition bwd": _measure_bf16_grad(
                     lambda: torch.autograd.grad(outs, leaves, cots,
                                                 retain_graph=True))}
            _report(f"{what} F={f} gy={gy is not None}", err, t)
            a32 = (x.float(), gm, bt, w1.float(), b1.float(), w2.float(),
                   b2.float(), 1e-5)
            _o32, y32, a_32, s32 = cm.ln_mlp_fwd_cuda(*a32,
                                                      save_residuals=True)
            b32 = (a32[0], y32, a_32, s32, go.float(),
                   None if gy is None else gy.float(), gm, a32[3], a32[5],
                   1e-5)
            add_f32("mlp_fwd", depth, lambda: cm.ln_mlp_fwd_cuda(*a32))
            add_f32("mlp_bwd", depth, lambda: cm.ln_mlp_bwd_cuda(*b32))
            del a32, b32, _o32, y32, a_32, s32
            flops_f = 4 * m_rows * c * f + 10 * m_rows * f + 8 * m_rows * c
            flops_b = 8 * m_rows * c * f + 4 * m_rows * f + 20 * m_rows * c
            for key, flops in (("kernel", flops_f), ("kernel bwd", flops_b)):
                if t[key][1]:
                    print(f"  {key} rate: {flops / t[key][1] / 1e9:.1f} "
                          "TFLOP/s (operations over device time)", flush=True)
            bytes_f = (3 * x.numel() + 2 * c * f + f + c) * 2 + 2 * c * 4
            bytes_b = ((5 if gy is not None else 4) * m_rows * c
                       + 2 * m_rows * f + 4 * c * f + f + c) * 2 + 3 * c * 4
            per_site(t, {"fwd": ("kernel", bytes_f, flops_f, 3),
                         "bwd": ("kernel bwd", bytes_b, flops_b, n_bwd)})
            tot["mlp_fwd"].add(depth, ms=t["kernel"][0],
                               device_ms=t["kernel"][1],
                               plain_ms=t["plain"][0],
                               plain_device_ms=t["plain"][1],
                               bytes=bytes_f, flops=flops_f)
            tot["mlp_bwd"].add(depth, ms=t["kernel bwd"][0],
                               device_ms=t["kernel bwd"][1],
                               plain_ms=t["plain bwd"][0],
                               plain_device_ms=t["plain bwd"][1],
                               bytes=bytes_b, flops=flops_b)
            for key in ("mlp_fwd", "mlp_bwd"):
                dv = t["composition" + (" bwd" if key == "mlp_bwd" else "")][1]
                comp[key] = (None if dv is None or comp[key] is None
                             else comp[key] + depth * dv)
            del x, args, bargs, got, want, res, again, ref, scratch, leaves
            del co, cy, outs
    print("bf16 Swin kernels, by output against the plain version it is held "
          "to: the largest share of values that differ, difference in units "
          "of its bound (one ulp, or the floor), and share beyond one ulp "
          "(end to end): " + json.dumps(
              {k: [round(v[0], 6), round(v[1], 3), v[2]]
               for k, v in apart.items()}), flush=True)

    src, ops = "vitta_tpu_torch/csrc", "vitta_tpu/ops"
    rows = [
        tot["ln_fwd"].row("ln_fwd_bf16", f"{src}/ln.cu",
                          f"{ops}/pallas_ln.py:47", flop_rate=BF16_FLOP_PER_S),
        tot["ln_bwd"].row("ln_bwd_bf16", f"{src}/ln.cu",
                          f"{ops}/pallas_ln.py:55", flop_rate=BF16_FLOP_PER_S),
        tot["attn_fwd"].row("attn_packed_fwd_bf16", f"{src}/attention.cu",
                            f"{ops}/pallas_attention.py:448",
                            flop_rate=BF16_FLOP_PER_S),
        tot["attn_bwd"].row("attn_packed_bwd_bf16", f"{src}/attention.cu",
                            f"{ops}/pallas_attention.py:517",
                            flop_rate=BF16_FLOP_PER_S),
        tot["mlp_fwd"].row("ln_mlp_fwd_bf16", f"{src}/gemm_wgmma_bf16.cuh",
                           f"{ops}/pallas_mlp.py:303", has_library=False,
                           flop_rate=BF16_FLOP_PER_S),
        tot["mlp_bwd"].row("ln_mlp_bwd_bf16", f"{src}/gemm_wgmma_bf16.cuh",
                           f"{ops}/pallas_mlp.py:322", has_library=False,
                           flop_rate=BF16_FLOP_PER_S)]
    # the product kernels the rows ran (mlp.cu's entries launch them)
    rows[4]["kernels_launched"] = sorted(wgmma["mlp_fwd"])
    rows[5]["kernels_launched"] = sorted(wgmma["mlp_bwd"])
    rows[4]["composition_device_ms"] = comp["mlp_fwd"]
    rows[5]["composition_device_ms"] = comp["mlp_bwd"]
    for row, key in zip(rows, ("ln_fwd", "ln_bwd", "attn_fwd", "attn_bwd",
                               "mlp_fwd", "mlp_bwd")):
        row["float32_device_ms"] = f32[key]
    rows[2]["dense_bias_device_ms"] = dense_ms["attn_fwd"]
    rows[3]["dense_bias_device_ms"] = dense_ms["attn_bwd"]
    rows[3]["library_without_dbias_device_ms"] = no_dbias
    for row in rows:
        print(f"{row['name']} per Swin-B pass of 2 clips: device ms kernel "
              f"{fmt(row['device_ms'])} float32 kernel "
              f"{fmt(row['float32_device_ms'])} plain "
              f"{fmt(row['plain_device_ms'])} "
              f"library {fmt(row['library_device_ms'])}"
              + (f" composition {fmt(row['composition_device_ms'])}"
                 if "composition_device_ms" in row else "")
              + (f" kernel on the dense bias "
                 f"{fmt(row['dense_bias_device_ms'])}"
                 if "dense_bias_device_ms" in row else "")
              + (f" library without dbias "
                 f"{fmt(row['library_without_dbias_device_ms'])}"
                 if "library_without_dbias_device_ms" in row else "")
              + f"; event ms {row['ms']:.4f} / {row['plain_ms']:.4f}; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} at bfloat16",
              flush=True)
    return rows


def phase_bf16_swin_t_kernels(dev):
    """Phase 30: the bfloat16 MLP without the LayerNorm and attention per
    (head, window) (rows 8, 9, 12 and 13 in the bfloat16 Swin-T) against
    their plain versions, held by vitta_tpu_torch/tools/bf16_checks.py as
    phase 25 holds rows 10, 11, 14 and 15: every step within one bfloat16
    ulp of the plain version on the kernel's own rounded intermediates (the
    MLP's a, dh and dhc, which its backward hands out on request; the
    attention's e and dl from its tapped instances), those against their
    plain values, the attention's out, dq, dk and dv end to end as phase
    25's; two backward runs bit-equal; launches per call from the
    libraries' counts, every one a bfloat16 instance, the MLP's backward
    count the library's own (``vitta_mlp_bwd_bf16_launches``) and its plans
    ``cuda_mlp.mlp_rows_plan`` and ``bf16_gemm_plan``.  The MLP at Swin-T's
    stages 1-2 (widths 96 and 192) runs csrc/mlp_fused_bf16.cuh: one
    launch forward (mlp_rows_bf16<C, false>), whose output without a and s
    is the bits of the one with them and which then allocates no (M, F)
    tensor; three backward (the row pass mlp_rows_bf16<C, true>, dw1 and dw2
    in one gemm_wgmma_bf16 launch, reduce_sums_kernel); forward at 1 and 2
    clips (the eval forward, without residuals, timed at 1), backward at 2;
    the attention per
    (head, window) at every Swin-T stage, forward at 1 and 2 clips,
    backward at 2, and at every Swin-B stage at 2 clips (values only), with
    and without mask, on q, k, v as views of the packed projection output;
    the packed bfloat16 pair at Swin-T's head counts (3, 6, 12, 24),
    compact bias, values only.  Device ms per Swin-T pass of 2 clips (CUDA
    graphs' replays) beside the bound at bfloat16, the float32 kernel's on
    the same values, the plain versions', the MLP's
    F.linear-F.gelu-F.linear composition at bfloat16 and its autograd
    backward, the attention's sdpa with the dense bias (and mask) as
    attn_mask and its backward with and without the bias's gradient.
    Returns the four JSON rows."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops import cuda_bias as cb
    from vitta_tpu_torch.ops import cuda_mlp as cm
    from vitta_tpu_torch.tools import bf16_checks as bc
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def bf(*shape, scale=1.0):
        return randn(*shape, scale=scale).to(bf16)

    def kernels(fn, want):
        names = launches_of(fn)
        _bf16_swin_launches(names)
        if sum(names.values()) != want:
            raise AssertionError(f"launches {names}, expected {want}")
        return names

    tot = {k: Totals() for k in ("mlp_fwd", "mlp_bwd", "heads_fwd",
                                 "heads_bwd")}
    f32 = dict.fromkeys(tot, 0.0)
    comp = {"mlp_fwd": 0.0, "mlp_bwd": 0.0}
    no_dbias = 0.0

    def note(row, result):
        tot[row].err = max(tot[row].err, result[2])

    def add(acc, key, sites, ms_):
        acc[key] = (None if acc[key] is None or ms_ is None
                    else acc[key] + sites * ms_)

    # rows 8 and 9: Swin-T's stages 1 and 2, where norm2 runs apart
    eval_ms = 0.0
    for c, _nh, tokens, _nw, depth in SWIN_T_STAGES[:2]:
        f = 4 * c
        w1, b1 = bf(f, c, scale=c ** -0.5), bf(f, scale=0.1)
        w2, b2 = bf(c, f, scale=f ** -0.5), bf(c, scale=0.1)
        for clips in (1, 2):
            m_rows = clips * tokens
            x = bf(m_rows, c)
            what = f"mlp bf16 M={m_rows} C={c}"
            if (cm.bf16_gemm_plan_cuda(m_rows, c, f)
                    != cm.bf16_gemm_plan(m_rows, c, f, sms)
                    or cm.mlp_rows_plan_cuda(m_rows, c, f)
                    != cm.mlp_rows_plan(m_rows, c, f, sms)):
                raise AssertionError(f"{what}: the library's plans are not "
                                     "cuda_mlp's")
            names = kernels(lambda: cm.mlp_fwd_cuda(x, w1, b1, w2, b2, True),
                            1)
            if names != {f"mlp_rows_bf16<{c}, false>": 1}:
                raise AssertionError(f"{what}: forward launches {names}")
            got = cm.mlp_fwd_cuda(x, w1, b1, w2, b2, save_residuals=True)
            for nm, p, q in zip(("o", "a", "s"), got, bc.mlp_fwd_stages(
                    x, w1, b1, w2, b2, got[1])):
                note("mlp_fwd", bc.assert_bf16_within(f"{what} {nm}", p, q))
            # without residuals: the same o, and no (M, F) tensor
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            o_eval = cm.mlp_fwd_cuda(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            grew = torch.cuda.max_memory_allocated(dev) - before
            if grew >= m_rows * f * 2 or not torch.equal(o_eval, got[0]):
                raise AssertionError(f"{what}: the forward without residuals "
                                     f"allocated {grew} bytes or gave other "
                                     "bits")
            del o_eval
            if clips == 1:
                # the eval forward: one clip, no residuals
                t_eval = _measure_bf16(lambda: cm.mlp_fwd_cuda(x, w1, b1, w2,
                                                               b2))
                eval_ms += depth * t_eval[1]
                print(f"{what} eval forward (no residuals, {grew} bytes "
                      f"allocated, o the residual forward's bits): event ms "
                      f"{t_eval[0]:.4f}, device {t_eval[1]:.4f}", flush=True)
                del x, got
                continue
            _o, a, s_ = got
            g = bf(m_rows, c)
            n_bwd = cm.mlp_bf16_bwd_launches_cuda(m_rows, c, f)
            if n_bwd != cm.bf16_bwd_launches(m_rows, c, f, sms, ln=False):
                raise AssertionError(f"{what}: {n_bwd} backward launches, "
                                     "not bf16_bwd_launches'")
            names = kernels(lambda: cm.mlp_bwd_cuda(x, a, s_, g, w1, w2),
                            n_bwd)
            if (n_bwd != 3 or names.get(f"mlp_rows_bf16<{c}, true>") != 1
                    or names.get("reduce_sums_kernel") != 1
                    or sum(n for k, n in names.items()
                           if k.startswith("gemm_wgmma_bf16")) != 1):
                raise AssertionError(f"{what}: backward launches {names}")
            taps = {}
            res = cm.mlp_bwd_cuda(x, a, s_, g, w1, w2, taps=taps)
            ref = bc.mlp_bwd_stages(x, a, s_, g, w1, w2, taps["dh"],
                                    taps["dhc"])
            again = cm.mlp_bwd_cuda(x, a, s_, g, w1, w2)
            if not all(torch.equal(p, q) for p, q in zip(res, again)):
                raise AssertionError(f"{what}: two backward runs differ")
            if not torch.equal(taps["dhc"], ref["dhc"]):
                raise AssertionError(f"{what}: dh is not rounded once")
            check_scaled(f"{what} dh", taps["dh"], ref["dh"], MLP_BWD_TOL)
            for nm, p in zip(("dx", "dw1", "db1", "dw2", "db2"), res):
                note("mlp_bwd", bc.assert_bf16_within(f"{what} {nm}", p,
                                                      ref[nm]))
            leaves = [t_.detach().requires_grad_()
                      for t_ in (x, w1, b1, w2, b2)]
            with torch.enable_grad():
                co = F.linear(F.gelu(F.linear(leaves[0], leaves[1],
                                              leaves[2])),
                              leaves[3], leaves[4])
            t = {"kernel": _measure_bf16(lambda: cm.mlp_fwd_cuda(
                     x, w1, b1, w2, b2, True)),
                 "plain": _measure_bf16(lambda: cm.mlp_bf16_reference(
                     x, w1, b1, w2, b2, True)),
                 "composition": _measure_bf16(lambda: F.linear(F.gelu(
                     F.linear(x, w1, b1)), w2, b2)),
                 "kernel bwd": _measure_bf16(lambda: cm.mlp_bwd_cuda(
                     x, a, s_, g, w1, w2)),
                 "plain bwd": _measure_bf16(
                     lambda: cm.mlp_bf16_backward_reference(x, a, s_, g, w1,
                                                            w2)),
                 "composition bwd": _measure_bf16_grad(
                     lambda: torch.autograd.grad(co, leaves, g,
                                                 retain_graph=True))}
            _report(f"{what} F={f}, backward {n_bwd} launches",
                    max(tot["mlp_fwd"].err, tot["mlp_bwd"].err), t)
            xf, a32 = x.float(), [v.float() for v in (w1, b1, w2, b2)]
            _o32, af, sf = cm.mlp_fwd_cuda(xf, *a32, save_residuals=True)
            gf = g.float()
            add(f32, "mlp_fwd", depth, graph_ms(
                lambda: cm.mlp_fwd_cuda(xf, *a32, save_residuals=True)))
            add(f32, "mlp_bwd", depth, graph_ms(
                lambda: cm.mlp_bwd_cuda(xf, af, sf, gf, a32[0], a32[2])))
            del xf, a32, _o32, af, sf, gf
            flops_f = 4 * m_rows * c * f + 10 * m_rows * f
            flops_b = 8 * m_rows * c * f + 4 * m_rows * f
            bytes_f = (2 * m_rows * c + 2 * m_rows * f + 2 * c * f + f
                       + c) * 2
            bytes_b = (3 * m_rows * c + 2 * m_rows * f + 4 * c * f + f
                       + c) * 2
            per_site(t, {"fwd": ("kernel", bytes_f, flops_f, 1),
                         "bwd": ("kernel bwd", bytes_b, flops_b, n_bwd)})
            tot["mlp_fwd"].add(depth, ms=t["kernel"][0],
                               device_ms=t["kernel"][1],
                               plain_ms=t["plain"][0],
                               plain_device_ms=t["plain"][1],
                               bytes=bytes_f, flops=flops_f)
            tot["mlp_bwd"].add(depth, ms=t["kernel bwd"][0],
                               device_ms=t["kernel bwd"][1],
                               plain_ms=t["plain bwd"][0],
                               plain_device_ms=t["plain bwd"][1],
                               bytes=bytes_b, flops=flops_b)
            add(comp, "mlp_fwd", depth, t["composition"][1])
            add(comp, "mlp_bwd", depth, t["composition bwd"][1])
            del x, got, a, s_, g, res, again, ref, taps, leaves, co

    # rows 12 and 13: every Swin-T stage (timed), then every Swin-B stage
    # (values only); the packed pair at Swin-T's head counts beside them
    wd, wh, ww = SWIN_WINDOW
    n_tok, hw = wd * wh * ww, wh * ww
    for model, stages in (("swin-T", SWIN_T_STAGES),
                          ("swin-B", SWIN_STAGES)):
        for c, nh, tokens, nw, depth in stages:
            hd, scale = c // nh, (c // nh) ** -0.5
            vc = randn(nh, 2 * wd - 1, hw, hw, scale=0.5)
            dense = cb.expand_bias_reference(vc, wd)
            mask = None
            if nw > 1:
                mask = torch.where(torch.rand(nw, n_tok, n_tok, device=dev,
                                              generator=gen) < 0.3,
                                   -100.0, 0.0)
                mask.diagonal(dim1=1, dim2=2).zero_()
            for clips in ((1, 2) if model == "swin-T" else (2,)):
                b_ = clips * tokens // n_tok
                split = ca.bwd_split(b_, nh, dev)
                qkv, g = bf(b_, n_tok, 3 * c), bf(b_, n_tok, nh, hd)
                q, k, v = qkv.reshape(b_, n_tok, 3, nh, hd).unbind(2)
                for m in ((None, mask) if mask is not None else (None,)):
                    what = (f"attention (heads) bf16 {model} B_={b_} "
                            f"nh={nh} hd={hd} mask={m is not None}")
                    names = kernels(lambda: ca.attn_heads_fwd_cuda(
                        q, k, v, dense, m, scale), 1)
                    if names != {"attn_fwd_dense_bf16_kernel": 1}:
                        raise AssertionError(f"{what}: forward launches "
                                             f"{names}")
                    plan_nw = nw if m is not None else 0
                    if (ca.dense_fwd_bf16_plan_cuda(b_, n_tok, nh, plan_nw,
                                                    True)
                            != ca.dense_fwd_bf16_plan(b_, n_tok, nh, plan_nw,
                                                      True, sms)):
                        raise AssertionError(f"{what}: the library's plan is "
                                             "not cuda_attention's")
                    tf = {}
                    out, ms_ = ca.attn_heads_fwd_cuda(q, k, v, dense, m,
                                                      scale, save_ms=True,
                                                      taps=tf)
                    again = ca.attn_heads_fwd_cuda(q, k, v, dense, m, scale,
                                                   save_ms=True)
                    if not (torch.equal(out, again[0])
                            and torch.equal(ms_, again[1])):
                        raise AssertionError(f"{what}: two forward runs "
                                             "differ")
                    del again
                    want, want_ms = ca.heads_attention_bf16_reference(
                        q, k, v, dense, m, scale, save_ms=True)
                    tot["heads_fwd"].err = max(tot["heads_fwd"].err,
                                               check_close(
                        f"{what} row max/sum", ms_, want_ms, ATTN_TOL))
                    e_want, dl_want = bc.heads_attention_bf16_intermediates(
                        q, k, v, dense, m, ms_, g, scale)
                    note("heads_fwd", bc.assert_bf16_within(
                        f"{what} forward e", tf["e"], e_want))
                    note("heads_fwd", bc.assert_bf16_within(
                        f"{what} out from the kernel's e", out,
                        bc.heads_attention_bf16_fwd_stage(v, ms_, tf["e"])))
                    slack = bc.heads_attention_bf16_slack(q, k, v, dense, m,
                                                          ms_, g, scale)
                    note("heads_fwd", bc.assert_bf16_mostly_within(
                        f"{what} out", out, want, slack[0]))
                    del want, want_ms
                    if clips == 1:
                        del tf, e_want, dl_want, slack
                        print(f"{what}: out within its bounds", flush=True)
                        continue
                    names = kernels(lambda: ca.attn_heads_bwd_cuda(
                        q, k, v, dense, m, ms_, g, scale), 2 + (split > 1))
                    if names.get(ca.dense_dbias_reduce_kernel(
                            n_tok, nh)) != 1:
                        raise AssertionError(f"{what}: launches {names}")
                    tb = {}
                    got = ca.attn_heads_bwd_cuda(q, k, v, dense, m, ms_, g,
                                                 scale, taps=tb)
                    again = ca.attn_heads_bwd_cuda(q, k, v, dense, m, ms_, g,
                                                   scale)
                    if not all(torch.equal(p_, q_)
                               for p_, q_ in zip(got, again)):
                        raise AssertionError(f"{what}: two backward runs "
                                             "differ")
                    # dbias: the kernel's dl added in window order, the
                    # plain version's order, to the bit
                    if not torch.equal(got[3], ca.dbias_in_window_order(
                            tb["dl"], dense)):
                        raise AssertionError(f"{what}: dbias is not its dl "
                                             "added in window order")
                    note("heads_bwd", bc.assert_bf16_within(
                        f"{what} backward e", tb["e"], e_want))
                    # the dense backward forms q k^T by the forward's
                    # products: its e is the forward's, bit for bit
                    if not torch.equal(tf["e"], tb["e"]):
                        apart = (tf["e"] != tb["e"]).float().mean()
                        raise AssertionError(
                            f"{what}: the forward's e is not the "
                            f"backward's: {apart:.2e} of values differ")
                    del tf
                    tot["heads_bwd"].err = max(tot["heads_bwd"].err,
                                               check_scaled(
                        f"{what} dl", tb["dl"], dl_want, ATTN_BWD_TOL))
                    wants = ca.heads_attention_bf16_backward_reference(
                        q, k, v, dense, m, ms_, g, scale)
                    stages_ = bc.heads_attention_bf16_bwd_stages(
                        q, k, ms_, g, tb["e"], tb["dl"], scale)
                    for nm, p_, st, w_, sl in zip(("dq", "dk", "dv"), got,
                                                  stages_, wants, slack[1:]):
                        note("heads_bwd", bc.assert_bf16_within(
                            f"{what} {nm} from the kernel's e and dl", p_,
                            st))
                        note("heads_bwd", bc.assert_bf16_mostly_within(
                            f"{what} {nm}", p_, w_, sl))
                    tot["heads_bwd"].err = max(tot["heads_bwd"].err,
                                               check_scaled(
                        f"{what} dbias", got[3], wants[3], ATTN_BWD_TOL))
                    del tb, again, stages_, e_want, dl_want, slack
                    sites = depth // 2 if mask is not None else depth
                    if model == "swin-B":
                        print(f"{what}, {split} block(s) a problem: every "
                              "output within its bounds, two runs bit-equal",
                              flush=True)
                        del got, wants
                        continue
                    q5 = qkv.reshape(b_, n_tok, 3, nh, hd).permute(
                        2, 0, 3, 1, 4)
                    leaves = [q5[i].detach().requires_grad_()
                              for i in range(3)]
                    am = (dense[None] if m is None else (
                        dense[None, None] + m[None, :, None]).expand(
                            b_ // nw, nw, nh, n_tok, n_tok).reshape(
                                b_, nh, n_tok, n_tok)).to(bf16)
                    am_g = am.expand(b_, nh, n_tok, n_tok).contiguous(
                        ).requires_grad_()
                    g4 = g.permute(0, 2, 1, 3)
                    with torch.enable_grad():
                        o_lib = F.scaled_dot_product_attention(
                            *leaves, attn_mask=am, scale=scale)
                        o_lib_b = F.scaled_dot_product_attention(
                            *leaves, attn_mask=am_g, scale=scale)
                    t = {"kernel": _measure_bf16(
                             lambda: ca.attn_heads_fwd_cuda(q, k, v, dense,
                                                            m, scale)),
                         "plain": _measure_bf16(
                             lambda: ca.heads_attention_bf16_reference(
                                 q, k, v, dense, m, scale)),
                         "sdpa": _measure_bf16(
                             lambda: F.scaled_dot_product_attention(
                                 q5[0], q5[1], q5[2], attn_mask=am,
                                 scale=scale)),
                         "kernel bwd": _measure_bf16(
                             lambda: ca.attn_heads_bwd_cuda(
                                 q, k, v, dense, m, ms_, g, scale)),
                         "plain bwd": _measure_bf16(
                             lambda: ca.heads_attention_bf16_backward_reference(
                                 q, k, v, dense, m, ms_, g, scale)),
                         "sdpa bwd": _measure_bf16_grad(
                             lambda: torch.autograd.grad(o_lib, leaves, g4,
                                                         retain_graph=True)),
                         "sdpa bwd with dbias": _measure_bf16_grad(
                             lambda: torch.autograd.grad(
                                 o_lib_b, leaves + [am_g], g4,
                                 retain_graph=True))}
                    _report(f"{what}, {split} block(s) a problem",
                            max(tot["heads_fwd"].err, tot["heads_bwd"].err),
                            t)
                    qf, gf = qkv.float(), g.float()
                    qf3 = qf.reshape(b_, n_tok, 3, nh, hd).unbind(2)
                    _o32, ms32 = ca.attn_heads_fwd_cuda(*qf3, dense, m, scale,
                                                        save_ms=True)
                    add(f32, "heads_fwd", sites, graph_ms(
                        lambda: ca.attn_heads_fwd_cuda(*qf3, dense, m,
                                                       scale)))
                    add(f32, "heads_bwd", sites, graph_ms(
                        lambda: ca.attn_heads_bwd_cuda(*qf3, dense, m, ms32,
                                                       gf, scale)))
                    del qf, gf, qf3, _o32, ms32
                    no_dbias = (None if no_dbias is None
                                or t["sdpa bwd"][1] is None
                                else no_dbias + sites * t["sdpa bwd"][1])
                    pairs = b_ * nh * n_tok * n_tok
                    extra = (dense.numel() + (0 if m is None
                                              else m.numel())) * 4
                    bytes_f = (qkv.numel() + out.numel()) * 2 + extra
                    bytes_b = ((2 * qkv.numel() + g.numel()) * 2
                               + ms_.numel() * 4 + dense.numel() * 4 + extra)
                    per_site(t, {"fwd": ("kernel", bytes_f,
                                         pairs * (4 * hd + 6), 1),
                                 "bwd": ("kernel bwd", bytes_b,
                                         pairs * (10 * hd + 12),
                                         2 + (split > 1))})
                    tot["heads_fwd"].add(
                        sites, ms=t["kernel"][0], device_ms=t["kernel"][1],
                        plain_ms=t["plain"][0],
                        plain_device_ms=t["plain"][1],
                        library_ms=t["sdpa"][0],
                        library_device_ms=t["sdpa"][1], bytes=bytes_f,
                        flops=pairs * (4 * hd + 6))
                    tot["heads_bwd"].add(
                        sites, ms=t["kernel bwd"][0],
                        device_ms=t["kernel bwd"][1],
                        plain_ms=t["plain bwd"][0],
                        plain_device_ms=t["plain bwd"][1],
                        library_ms=t["sdpa bwd with dbias"][0],
                        library_device_ms=t["sdpa bwd with dbias"][1],
                        bytes=bytes_b, flops=pairs * (10 * hd + 12))
                    del got, wants, leaves, am, am_g, o_lib, o_lib_b, q5
                if model == "swin-T" and clips == 2:
                    # the packed pair at this head count, compact bias
                    what = f"attention bf16 (packed) B_={b_} nh={nh}"
                    qkv_g = bf(b_, n_tok, c)
                    for m in ((None, mask) if mask is not None else (None,)):
                        out, ms_ = ca.attn_packed_fwd_cuda(
                            qkv, vc, m, scale, nh, save_ms=True)
                        dqkv, dbias = ca.attn_packed_bwd_cuda(
                            qkv, vc, m, ms_, qkv_g, scale, nh)
                        s_out, s_dqkv = bc.packed_attention_bf16_slack(
                            qkv, vc, m, ms_, qkv_g, scale, nh)
                        wq, wb = ca.packed_attention_bf16_backward_reference(
                            qkv, vc, m, ms_, qkv_g, scale, nh)
                        bc.assert_bf16_mostly_within(
                            f"{what} out", out,
                            ca.packed_attention_bf16_reference(
                                qkv, vc, m, scale, nh), s_out)
                        bc.assert_bf16_mostly_within(f"{what} dqkv", dqkv,
                                                     wq, s_dqkv)
                        check_scaled(f"{what} dbias", dbias, wb,
                                     ATTN_BWD_TOL)
                        del out, ms_, dqkv, dbias, s_out, s_dqkv, wq, wb
                    print(f"{what} (Swin-T's heads): out, dqkv and the "
                          "compact dbias within their bounds", flush=True)
                    del qkv_g
                del qkv, g, q, k, v
    src, ops = "vitta_tpu_torch/csrc", "vitta_tpu/ops"
    rows = [tot["mlp_fwd"].row("mlp_rows_fwd_bf16",
                               f"{src}/mlp_fused_bf16.cuh",
                               f"{ops}/pallas_mlp.py:138", has_library=False,
                               flop_rate=BF16_FLOP_PER_S),
            tot["mlp_bwd"].row("mlp_rows_bwd_bf16",
                               f"{src}/mlp_fused_bf16.cuh",
                               f"{ops}/pallas_mlp.py:154", has_library=False,
                               flop_rate=BF16_FLOP_PER_S),
            tot["heads_fwd"].row("attn_heads_fwd_bf16", f"{src}/attention.cu",
                                 f"{ops}/pallas_attention.py:83",
                                 flop_rate=BF16_FLOP_PER_S),
            tot["heads_bwd"].row("attn_heads_bwd_bf16", f"{src}/attention.cu",
                                 f"{ops}/pallas_attention.py:91",
                                 flop_rate=BF16_FLOP_PER_S)]
    rows[0]["composition_device_ms"] = comp["mlp_fwd"]
    rows[1]["composition_device_ms"] = comp["mlp_bwd"]
    # the eval forward: 1 clip, no residuals, device ms a pass
    rows[0]["eval_device_ms"] = eval_ms
    print(f"mlp_rows_fwd_bf16 eval forward (1 clip, no residuals) per Swin-T "
          f"pass: device ms {eval_ms:.4f}", flush=True)
    rows[3]["library_without_dbias_device_ms"] = no_dbias
    for row, key in zip(rows, tot):
        row["float32_device_ms"] = f32[key]
    for row in rows:
        print(f"{row['name']} per Swin-T pass of 2 clips: device ms kernel "
              f"{fmt(row['device_ms'])} float32 kernel "
              f"{fmt(row['float32_device_ms'])} plain "
              f"{fmt(row['plain_device_ms'])} library "
              f"{fmt(row['library_device_ms'])}"
              + (f" composition {fmt(row['composition_device_ms'])}"
                 if "composition_device_ms" in row else "")
              + (f" library without dbias "
                 f"{fmt(row['library_without_dbias_device_ms'])}"
                 if "library_without_dbias_device_ms" in row else "")
              + f"; event ms {row['ms']:.4f} / {row['plain_ms']:.4f}; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} at bfloat16",
              flush=True)
    return rows


BF16_SWIN_SMALL = dict(embed_dim=128, depths=(2, 1), num_heads=(4, 8),
                       window_size=(2, 3, 3))


# Swin-T's first two widths (norm2 apart from the MLP), its heads there
BF16_SWIN_T_SMALL = dict(embed_dim=96, depths=(2, 1), num_heads=(3, 6),
                         window_size=(2, 3, 3))


def phase_bf16_swin_small(seed, t=4, hw=48, model=BF16_SWIN_SMALL,
                          route="packed", what="swin small slice (bfloat16)",
                          tta=None, epoch=False):
    """Phase 26: two tta_online steps of a small bfloat16 Swin (Swin-B's
    first width, every width a multiple of 128 so that norm2 runs inside
    the LayerNorm-MLP as on Swin-B: embed 128, depths (2, 1), heads (4, 8),
    window (2, 3, 3), 4 x 48 x 48), drop-path and head dropout 0, lr 1e-3,
    on the card and on the CPU from one seeded state dict and the source
    statistics of the float32 model; held as the bfloat16 TANet's small
    slice (``_assert_bf16_slice``).  Both round where the kernels round
    (the CPU through the plain versions); cuBLAS and oneDNN round the qkv,
    proj and merging products and cuDNN and oneDNN the patch embedding
    each their own way.  Phase 31 runs it on ``BF16_SWIN_T_SMALL`` (Swin-T's
    widths 96 and 192: norm2 apart, the MLP without the LayerNorm) under
    ``route`` "packed" and "heads".  Phase 27 runs it under the ``tta``
    overrides of ``stat_reg="cossim"`` (the relation-map targets of one
    clean batch) and, with ``epoch``, as ``tta_epoch_adapt`` (two
    adapt-only steps, then one evaluation pass)."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import tta_epoch_adapt
    from vitta_tpu_torch.adapt.precompute import (compute_cossim_statistics,
                                                  compute_source_statistics)
    cfg = _swin_cfg(t=t, hw=hw, **model)
    chosen = ("layers.1", "backbone.norm")
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr=1e-3),
                      tta=dataclasses.replace(cfg.tta, chosen_blocks=chosen,
                                              **(tta or {})))
    sd = _swin_weights(cfg, seed)
    rng = np.random.default_rng(seed)
    batches = _normalized_batches(rng, cfg, (2,), t, hw)
    if cfg.tta.stat_reg == "cossim":
        src = compute_cossim_statistics(
            _swin_model(cfg, sd), batches, clip_len=t, device="cpu",
            tap_filter=lambda n: "patch_embed" not in n)
    else:
        src = compute_source_statistics(_swin_model(cfg, sd), batches,
                                        device="cpu")
    videos = _videos(rng, 2, t, hw)
    _reset_swin_counts()
    runs = {}
    for dev in ("cuda", "cpu"):
        names = {}
        eng = VittaEngine(_synthetic_swin(cfg, "bfloat16", attn_route=route,
                                          drop_path_rate=0.0,
                                          head_dropout=0.0),
                          cfg, sd, src, device=dev)
        state = eng.init_state()
        metrics = []

        def steps():
            nonlocal state
            if epoch:
                top1, state = tta_epoch_adapt(
                    eng, videos, [(c, lb) for _v, c, lb in videos],
                    seed=seed)
                metrics.append({"top1": top1})
                return
            for views, clip, label in videos:
                state, m = eng.adapt_eval_step(state, views, clip, label)
                metrics.append({f: float(getattr(m, f)) for f in
                                ("loss_reg", "loss_consis", "loss_ce")})
        names = launches_of(steps)
        if dev == "cuda":
            _bf16_swin_launches(names)
        runs[dev] = (metrics, eng.eval_logits(videos[-1][1]).cpu(),
                     {k: p.detach().cpu()
                      for k, p in eng.model.named_parameters()},
                     {k: (v.mean.cpu(), v.var.cpu())
                      for k, v in state.ema.items()})
    counts = _swin_counts()
    fwd, bwd = swin_launches(route, model["embed_dim"], model["depths"],
                             "bfloat16")
    for k, n in {**fwd, **bwd}.items():
        if bool(n) != bool(counts[k]):
            raise AssertionError(f"{what}: the {k} kernel launched "
                                 f"{counts[k]} times, where a pass makes {n}")
    _assert_bf16_slice(what, sd, runs,
                       {k: counts[k] for k, n in {**fwd, **bwd}.items()
                        if n})


def phase_bf16_swin_full(cfg, sd, stats, seed, card,
                         n_videos=SWIN_ADAPT_VIDEOS, warmup=2,
                         attn_route="packed", what="swin-B"):
    """Phase 27: Swin-B's tta_stream at bfloat16 (``Recognizer3D(...,
    dtype="bfloat16")``, the construction of vitta_tpu's bench.py:117;
    float32 masters, SGD, losses and statistics) over seeded videos with
    the float32 model's source statistics, drop-path 0.2 and head dropout
    0.5: per video 2 x (29, 0, 24, 24) forward and 29 / 0 / 24 / 24
    backward launches of LayerNorm / bias / attention / LayerNorm-MLP (the
    attention takes the compact bias: no expansion, no collapse),
    every LayerNorm, attention and LayerNorm-MLP launch a bfloat16 kernel
    by the libraries' own counts and none a float32 one, no contiguity
    copy; ms/video, peak memory, then one profiled step: host, device busy,
    idle share, busy by class of kernel.  Phase 32 runs it on Swin-T
    under ``attn_route`` "packed" and "heads" (``swin_launches``' counts:
    the MLP without the LayerNorm at stages 1-2, and under "heads" the
    attention per (head, window) on the float32 bias expansion and
    collapse).  Returns (launch counts, summary)."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import tta_stream
    t, hw = cfg.data.clip_length, cfg.data.input_size
    engine = VittaEngine(_synthetic_swin(cfg, "bfloat16",
                                         attn_route=attn_route),
                         cfg, sd, stats)
    rng = np.random.default_rng(seed + 1)
    videos = _videos(rng, n_videos, t, hw)
    writer = _StepTimes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_swin_counts()
    box = {}

    def run():
        box["out"] = tta_stream(engine, videos, seed=seed,
                                metrics_writer=writer)
    names = launches_of(run)
    torch.cuda.synchronize()
    top1, state, meters = box["out"]
    counts = _swin_counts()
    peak = torch.cuda.max_memory_allocated()
    _bf16_swin_launches(names)
    # every LayerNorm forward (standalone, and the first step of the
    # LayerNorm-MLP and ln_proj chains) in 16-byte units: none one value at
    # a time
    if names.get("ln_rows_any<__nv_bfloat16>"):
        raise AssertionError(f"bf16 {what}: {names} holds one-value "
                             "LayerNorm forward launches")
    # the standalone LayerNorm backward: one ln_bwd_bf16x8 launch a call,
    # none of the two-launch instance (ln_bwd_kernel<..., __nv_bfloat16,
    # __nv_bfloat16> and its reduce); the LayerNorm-MLP's LayerNorm step is
    # ln_bwd_kernel<..., __nv_bfloat16, float>
    ln_one = sum(n for k, n in names.items() if k.startswith("ln_bwd_bf16x8<"))
    ln_two = sum(n for k, n in names.items() if k.startswith("ln_bwd_kernel<")
                 and k.endswith("__nv_bfloat16, __nv_bfloat16>"))
    ln_fwd16 = sum(n for k, n in names.items()
                   if k.startswith("ln_fwd_bf16x8<"))
    if ln_one != counts["ln_bwd"] or ln_two:
        raise AssertionError(f"bf16 {what}: {ln_one} ln_bwd_bf16x8 and "
                             f"{ln_two} two-launch LayerNorm backward "
                             f"launches for {counts['ln_bwd']} calls")
    for k in ("loss_reg", "loss_consis", "loss_ce"):
        if not np.isfinite(meters[k].avg):
            raise AssertionError(f"bf16 {what} {k} is not finite")
    logits = engine.eval_logits(videos[-1][1])
    if (tuple(logits.shape) != (1, cfg.model.num_classes)
            or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"bf16 {what} eval logits are not finite "
                             "float32")
    fwd, bwd = swin_launches(attn_route, cfg.model.embed_dim,
                             cfg.model.depths, "bfloat16")
    for k, per_pass in fwd.items():
        if counts[k] != 2 * per_pass * n_videos:
            raise AssertionError(f"bf16 {what} {k}: {counts[k]} launches over "
                                 f"{n_videos} videos, expected 2 x {per_pass}")
    for k, per_pass in bwd.items():
        if counts[k] != per_pass * n_videos:
            raise AssertionError(f"bf16 {what} {k}: {counts[k]} launches over "
                                 f"{n_videos} videos, expected {per_pass}")
    if counts["contiguity_copies"]:
        raise AssertionError(f"bf16 {what}: contiguity copies")
    for k, p in engine.model.named_parameters():
        if p.dtype != torch.float32 or p.grad is None or not bool(
                torch.isfinite(p.grad).all()):
            raise AssertionError(f"bf16 {what} {k}: no finite float32 "
                                 "gradient on a float32 master")
    warm = writer.ms[warmup:]
    summary = {"model": what, "route": attn_route, "dtype": "bfloat16",
               "videos": len(warm), "median_ms": statistics.median(warm),
               "min_ms": min(warm), "max_ms": max(warm),
               "peak_gib": peak / 2**30}
    print(f"{what} bfloat16 adapt full slice ({attn_route}): {n_videos} "
          f"videos, median {summary['median_ms']:.3f} ms/video (min "
          f"{min(warm):.3f}, max "
          f"{max(warm):.3f}) after {warmup} warm-up, peak memory "
          f"{summary['peak_gib']:.3f} GiB, losses reg "
          f"{meters['loss_reg'].avg:.5f} consis "
          f"{meters['loss_consis'].avg:.5f}, launches {counts}; the "
          f"standalone LayerNorm backward {ln_one // n_videos} launches a "
          f"video, one a call (the libraries' counts); the LayerNorm "
          f"forward in 16-byte units {ln_fwd16 // n_videos} launches a "
          f"video, one value at a time 0; bfloat16 "
          f"kernel instances "
          f"{sum(n for k, n in names.items() if _bf16_name(k))}; on {card}",
          flush=True)
    views, clip, label = (torch.from_numpy(a).cuda() for a in videos[-1])
    st = [state]

    def step():
        st[0], _m = engine.adapt_eval_step(st[0], views, clip, label)
    host_ms, busy, rows = device_breakdown(step, top=None)
    if busy == 0:
        print(f"{what} bfloat16 adapt step ({attn_route}): device time not "
              "measured", flush=True)
        return counts, summary
    classes = {}
    for k, ms, n in rows:
        cls = ("the port's kernels" if "vitta::" in k or k.startswith((
                   "expand_bias", "collapse_bias", "(anonymous namespace)"))
               else "cuBLAS / cuDNN products" if any(
                s in k for s in ("gemm", "nvjet", "xmma", "cutlass", "conv",
                                 "sm90")) else "elementwise" if any(
                s in k for s in ("elementwise", "vectorized", "Elementwise"))
            else "reductions" if "reduce" in k.lower() else "other")
        ms0, n0 = classes.get(cls, (0.0, 0))
        classes[cls] = (ms0 + ms, n0 + n)
    summary.update(host_ms=host_ms, device_busy_ms=busy,
                   idle_share=max(0.0, 1 - busy / host_ms))
    print(f"{what} bfloat16 adapt step ({attn_route}), profiled: host "
          f"{host_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{summary['idle_share']:.2f}; by class: "
          + "; ".join(f"{c} {ms:.3f} ms x{n}" for c, (ms, n) in
                      sorted(classes.items(), key=lambda kv: -kv[1][0]))
          + "; largest kernels: "
          + "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for k, ms, n in rows[:12]),
          flush=True)
    return counts, summary


def phase_bf16_swin_trajectories(cfg, sd, stats, card, n_videos,
                                 seed=SEED, what="Swin-B"):
    """Phase 28: float32 against bfloat16 Swin-B on the card, the quantities
    of benchmarks/bf16_gate.py (swin): the same float32 masters, source
    statistics and uint8 videos (one seeded generator a video), drop-path
    and dropout masks from the same seeds, through ``adapt_eval_step`` at
    each dtype, held to GATE_BOUNDS.  Phase 33 runs it on Swin-T."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import video_seed
    t, hw = cfg.data.clip_length, cfg.data.input_size
    classes = cfg.model.num_classes

    def stream(dtype):
        engine = VittaEngine(_synthetic_swin(cfg, dtype), cfg, sd, stats)
        state = engine.init_state()
        out = {f: [] for f in ("pred", "loss_reg", "loss_consis", "top1")}
        for i in range(n_videos):
            rng = np.random.default_rng(20_000 + i)
            views = rng.integers(0, 256, (2, t, hw, hw, 3), dtype=np.uint8)
            clip = rng.integers(0, 256, (1, t, hw, hw, 3), dtype=np.uint8)
            label = np.asarray([i % classes], np.int64)
            engine.generator.manual_seed(video_seed(seed, i))
            state, m = engine.adapt_eval_step(state, views, clip, label)
            out["pred"].append(int(m.pred[0]))
            for f in ("loss_reg", "loss_consis", "top1"):
                out[f].append(float(getattr(m, f)))
        params = torch.cat([p.detach().double().flatten()
                            for p in engine.model.parameters()])
        ema = torch.cat([x.detach().double().flatten()
                         for s in state.ema.values() for x in s])
        return {k: np.asarray(v) for k, v in out.items()}, params, ema

    t0 = time.perf_counter()
    t32, p32, e32 = stream("float32")
    t16, p16, e16 = stream("bfloat16")
    rel = lambda a, b: float((a - b).norm() / b.norm())
    gate = {
        "n_videos": n_videos,
        "pred_agreement": float(np.mean(t32["pred"] == t16["pred"])),
        "top1_fp32": float(np.mean(t32["top1"])) / 100,
        "top1_bf16": float(np.mean(t16["top1"])) / 100,
        "reg_loss_max_absdiff": float(np.max(np.abs(t32["loss_reg"]
                                                    - t16["loss_reg"]))),
        "reg_loss_final_reldiff": float(
            abs(t32["loss_reg"][-1] - t16["loss_reg"][-1])
            / max(abs(t32["loss_reg"][-1]), 1e-9)),
        "consis_loss_max_absdiff": float(np.max(np.abs(
            t32["loss_consis"] - t16["loss_consis"]))),
        "consis_loss_max_fp32": float(np.max(t32["loss_consis"])),
        "params_rel_l2_drift": rel(p16, p32),
        "ema_rel_l2_drift": rel(e16, e32)}
    print(f"{what} fp32 against bf16 trajectories ({n_videos} videos each, "
          f"{time.perf_counter() - t0:.1f} s): " + json.dumps(gate)
          + f"; on {card}", flush=True)
    bad = [k for k, (op, lim) in GATE_BOUNDS.items()
           if not (gate[k] >= lim if op == ">=" else gate[k] <= lim)]
    if gate["consis_loss_max_absdiff"] > (
            0.1 * gate["consis_loss_max_fp32"] + 1e-4):
        bad.append("consis_loss_max_absdiff")
    if bad:
        raise AssertionError(f"{what} bf16 trajectories beyond their bounds: "
                             f"{bad}")
    return gate


def phase_bf16_swin_interleaved(cfg, sd, stats, seed, card, rounds=3):
    """Phase 29: Swin-B adapt+eval steps at float32, at bfloat16 with the
    engine's bfloat16 twin of the cast weights (the default) and at
    bfloat16 casting them at every use (``half_twin=False``), in turns in
    one process (the three, then the three backwards, ``rounds`` times,
    after two warm-up steps each), one engine each built once, on one
    seeded video with its inputs on the card: per step the host's time to
    enqueue it (until ``adapt_eval_step`` returns) and its wall time (until
    the card has finished); then one profiled step of each: device busy,
    launches, and the launches and busy time of copy kernels (the dtype
    casts among them).  Returns {variant: {"enqueue": [ms], "wall": [ms],
    ...}}."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    t, hw = cfg.data.clip_length, cfg.data.input_size
    views, clip, label = (torch.from_numpy(a).cuda() for a in
                          _videos(np.random.default_rng(seed + 3), 1, t,
                                  hw)[0])
    variants = {"float32": ("float32", True),
                "bfloat16": ("bfloat16", True),
                "bfloat16, cast at use": ("bfloat16", False)}
    engines = {v: VittaEngine(_synthetic_swin(cfg, d), cfg, sd, stats,
                              half_twin=twin)
               for v, (d, twin) in variants.items()}
    if (engines["bfloat16"]._twin is None
            or engines["bfloat16, cast at use"]._twin is not None):
        raise AssertionError("bf16 swin-B: the twin is not where asked")
    states = {v: e.init_state() for v, e in engines.items()}
    out = {v: {"enqueue": [], "wall": []} for v in variants}

    def step(v):
        states[v], _m = engines[v].adapt_eval_step(states[v], views, clip,
                                                   label)
    for v in variants:
        for _ in range(2):
            step(v)
    order = list(variants)
    for _ in range(rounds):
        for v in order + order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(v)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out[v]["enqueue"].append((t1 - t0) * 1e3)
            out[v]["wall"].append((t2 - t0) * 1e3)
    for v in variants:
        _host, busy, rows = device_breakdown(lambda: step(v), top=None)
        casts = [(ms, n) for k, ms, n in rows if "copy" in k.lower()]
        r = out[v]
        r.update(busy=busy if busy > 0 else None,
                 launches=sum(n for _k, _ms, n in rows),
                 cast_launches=sum(n for _ms, n in casts),
                 cast_ms=sum(ms for ms, _n in casts))
        print(f"swin-B adapt step {v}, in turns with the others: enqueue "
              f"median {statistics.median(r['enqueue']):.3f} ms ("
              + ", ".join(f"{x:.1f}" for x in r["enqueue"]) + "), wall "
              f"median {statistics.median(r['wall']):.3f} ms ("
              + ", ".join(f"{x:.1f}" for x in r["wall"]) + "); profiled: "
              f"device busy {fmt(r['busy'])} ms, {r['launches']} launches, "
              f"of which copy kernels (dtype casts among them) "
              f"{r['cast_launches']} taking {r['cast_ms']:.3f} ms; on {card}",
              flush=True)
    del engines, states
    return out


def _quick_bf16(fn):
    """(CUDA-event ms, device ms from a CUDA graph's replay) of ``fn``, with
    fewer runs than ``_measure_bf16``: phase 34 times eight ops at seven
    shapes."""
    return cuda_ms(fn, reps=3, warmup=1), graph_ms(fn, calls=3, reps=2)


def phase_bf16_proj_kernels(dev):
    """Phase 34: the bfloat16 projection-fused attention, with and without
    the LayerNorm, forward and backward (rows 16-19 at bfloat16) against
    their plain versions at every Swin-B and Swin-T stage shape: forward
    at 1 clip (values: qkv and out by the Dense bound, o_att end to end),
    and at 2 clips, with and without the mask, ``attn_proj``, and
    ``attn_ln_proj`` with and without a cotangent on y, every step on the
    kernel's own intermediates (``bf16_checks.check_proj_bf16``: qkv,
    o_att, g_att, dqkv, dl and dy, e from the attention's tapped
    instances), two backward runs bit-equal, the launches of a call the
    library's count and within the chain's budget (8, 11), every one a
    bfloat16 instance.  Phase 35: at Swin-B's shapes (2 clips) device ms
    from CUDA graphs' replays beside the float32 kernel's on the same
    values, the plain versions', the bound at bfloat16 (bytes over 3.35
    TB/s, operations over 989 TFLOP/s), ``F.multi_head_attention_forward``
    at bfloat16 for ``attn_proj`` (its backward under autograd, without
    the bias's gradient) and the composition each op replaces (the
    LayerNorm kernel, F.linear, the bfloat16 packed attention kernel on
    the dense bias, F.linear; its backward under autograd), summed over the
    24 sites of a Swin-B pass of 2 clips.  Returns the four JSON rows."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_attention as ca
    from vitta_tpu_torch.ops import cuda_attention_proj as cp
    from vitta_tpu_torch.ops import cuda_bias as cb
    from vitta_tpu_torch.ops import cuda_ln as cl
    from vitta_tpu_torch.tools import bf16_checks as bc
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    wd, wh, ww = SWIN_WINDOW
    hw, n_tok = wh * ww, wd * wh * ww
    eps = 1e-5
    keys = ("proj_fwd", "proj_bwd", "ln_proj_fwd", "ln_proj_bwd")
    tot = {k: Totals() for k in keys}
    f32 = dict.fromkeys(keys, 0.0)
    comp = dict.fromkeys(keys, 0.0)
    per_call = {"proj_bwd": set(), "ln_proj_bwd": set()}

    def add(acc, key, sites, ms_):
        acc[key] = (None if acc[key] is None or ms_ is None
                    else acc[key] + sites * ms_)

    for model, stages in (("swin-B", SWIN_STAGES), ("swin-T", SWIN_T_STAGES)):
        for stage, (c, nh, tokens, nw, depth) in enumerate(stages):
            hd, scale = c // nh, (c // nh) ** -0.5
            gm, bt = 1 + 0.1 * randn(c), 0.1 * randn(c)
            w = (randn(3 * c, c, scale=c ** -0.5).to(bf16),
                 (0.1 * randn(3 * c)).to(bf16),
                 randn(c, c, scale=c ** -0.5).to(bf16),
                 (0.1 * randn(c)).to(bf16))
            dense = cb.expand_bias_reference(
                randn(nh, 2 * wd - 1, hw, hw, scale=0.5), wd)
            mask = None
            if nw > 1:
                mask = torch.where(torch.rand(nw, n_tok, n_tok, device=dev,
                                              generator=gen) < 0.3,
                                   -100.0, 0.0)
                mask.diagonal(dim1=1, dim2=2).zero_()
            for clips in (1, 2):
                b_ = clips * tokens // n_tok
                m_rows = b_ * n_tok
                x = (randn(b_, n_tok, c, scale=1.5) + 0.3).to(bf16)
                g = randn(b_, n_tok, c).to(bf16)
                gy = (0.3 * randn(b_, n_tok, c)).to(bf16)
                for m in ((None, mask) if mask is not None else (None,)):
                    tag = (f"{model} B_={b_} N={n_tok} C={c} nh={nh} mask="
                           f"{m is not None}")
                    sites = depth // 2 if mask is not None else depth
                    if clips == 1:   # the eval batch: values only
                        for ln in (None, (gm, bt, eps)):
                            outs = (cp.attn_proj_fwd(x, *w, dense, m, scale,
                                                     nh, True)
                                    if ln is None else cp.attn_ln_proj_fwd(
                                        x, *ln, *w, dense, m, scale, nh,
                                        True))
                            y = x if ln is None else outs[1]
                            out, qkv, o_att, ms_ = (outs if ln is None else
                                                    (outs[0],) + outs[2:])
                            bc.assert_dense_within("qkv", qkv, y, w[0], w[1])
                            bc.assert_dense_within("out", out, o_att, w[2],
                                                   w[3])
                            bc.assert_bf16_mostly_within(
                                "o_att", o_att,
                                ca.packed_attention_bf16_reference(
                                    qkv, dense, m, scale, nh),
                                bc.packed_attention_bf16_slack(
                                    qkv, dense, m, ms_, g, scale, nh)[0])
                            del outs, y, out, qkv, o_att, ms_
                        print(f"attn_proj / attn_ln_proj bf16 fwd {tag}: "
                              "qkv, out and o_att within their bounds",
                              flush=True)
                        continue
                    checks = {}
                    for op, ln, g_y in (("proj", None, None),
                                        ("ln_proj gy", (gm, bt, eps), gy),
                                        ("ln_proj", (gm, bt, eps), None)):
                        r = bc.check_proj_bf16(x, ln, *w, dense, m, scale,
                                               nh, g, g_y)
                        checks[op] = r
                        per_call["proj_bwd" if ln is None
                                 else "ln_proj_bwd"].add(r["launches"][1])
                        key = "proj" if ln is None else "ln_proj"
                        for side in ("fwd", "bwd"):
                            tot[f"{key}_{side}"].err = max(
                                tot[f"{key}_{side}"].err, r["abs"][side])
                    print(f"attn_proj / attn_ln_proj bf16 {tag}: every step "
                          "within its bounds, two backward runs bit-equal; "
                          "launches forward / backward "
                          + ", ".join(f"{k} {v['launches']}"
                                      for k, v in checks.items())
                          + "; values an ulp apart " + json.dumps(
                              {k: {n: float(f"{a:.2e}") for n, a in
                                   v["apart"].items()}
                               for k, v in checks.items()}), flush=True)
                    if model == "swin-T":
                        del checks
                        continue
                    # phase 35: times at Swin-B's shapes
                    _o, qkv_, o_att, ms_ = checks["proj"]["fwd"]
                    _o, y_ln, qkv_ln, o_ln, ms_ln = checks["ln_proj gy"]["fwd"]
                    del checks, _o
                    g_y = gy if stage >= 2 else None
                    pargs = (x, qkv_, w[0], w[2], dense, m, o_att, ms_, g,
                             scale, nh)
                    largs = (x, y_ln, qkv_ln, gm, eps, w[0], w[2], dense, m,
                             o_ln, ms_ln, g, g_y, scale, nh)

                    def composition(xin, wts, with_ln, bias_=dense):
                        y = cl.layer_norm(xin, gm, bt, eps) if with_ln \
                            else xin
                        o = ca.window_attention_packed(
                            F.linear(y, wts[0], wts[1]), bias_, m, scale, nh)
                        return F.linear(o, wts[2], wts[3]), y

                    am = (dense[None] if m is None else
                          dense[None, None] + m[None, :, None]).expand(
                              b_ // nw, nw, nh, n_tok, n_tok).reshape(
                                  b_ * nh, n_tok, n_tok).to(bf16)
                    x_t = x.transpose(0, 1).contiguous()

                    def mha(xin, wq, bq, wp_, bp_):
                        return F.multi_head_attention_forward(
                            xin, xin, xin, c, nh, wq, bq, None, None, False,
                            0.0, wp_, bp_, training=False,
                            need_weights=False, attn_mask=am)[0]

                    t = {"proj": _quick_bf16(lambda: cp.attn_proj_fwd(
                             x, *w, dense, m, scale, nh)),
                         "ln_proj": _quick_bf16(lambda: cp.attn_ln_proj_fwd(
                             x, gm, bt, eps, *w, dense, m, scale, nh)),
                         "proj plain": _quick_bf16(
                             lambda: cp.proj_attention_bf16_reference(
                                 x, *w, dense, m, scale, nh)),
                         "ln_proj plain": _quick_bf16(
                             lambda: cp.ln_proj_attention_bf16_reference(
                                 x, gm, bt, eps, *w, dense, m, scale, nh)),
                         "proj library": _quick_bf16(lambda: mha(x_t, *w)),
                         "proj composition": _quick_bf16(
                             lambda: composition(x, w, False)),
                         "ln_proj composition": _quick_bf16(
                             lambda: composition(x, w, True)),
                         "proj bwd": _quick_bf16(
                             lambda: cp.attn_proj_bwd(*pargs)),
                         "ln_proj bwd": _quick_bf16(
                             lambda: cp.attn_ln_proj_bwd(*largs)),
                         "proj bwd plain": _quick_bf16(
                             lambda: cp.proj_attention_bf16_backward_reference(
                                 *pargs)),
                         "ln_proj bwd plain": _quick_bf16(
                             lambda:
                             cp.ln_proj_attention_bf16_backward_reference(
                                 *largs))}
                    leaves = [v.detach().clone().requires_grad_()
                              for v in (x,) + w]
                    bias_l = dense.detach().clone().requires_grad_()
                    lib_leaves = [v.detach().clone().requires_grad_()
                                  for v in (x_t,) + w]
                    g_t = g.transpose(0, 1).contiguous()
                    with torch.enable_grad():
                        out_c, _y = composition(leaves[0], leaves[1:], False,
                                                bias_l)
                        out_cl, y_cl = composition(leaves[0], leaves[1:],
                                                   True, bias_l)
                        out_lib = mha(*lib_leaves)
                    outs_l, cots_l = (([out_cl, y_cl], [g, g_y])
                                      if g_y is not None else ([out_cl], [g]))
                    t["proj bwd library"] = _measure_bf16_grad(
                        lambda: torch.autograd.grad(out_lib, lib_leaves, g_t,
                                                    retain_graph=True))
                    t["proj bwd composition"] = _measure_bf16_grad(
                        lambda: torch.autograd.grad(
                            out_c, leaves + [bias_l], g, retain_graph=True))
                    t["ln_proj bwd composition"] = _measure_bf16_grad(
                        lambda: torch.autograd.grad(
                            outs_l, leaves + [bias_l], cots_l,
                            retain_graph=True))
                    del out_c, _y, out_cl, y_cl, out_lib, outs_l, leaves
                    del lib_leaves, g_t
                    _report(f"attn_proj / attn_ln_proj bf16 {tag}",
                            max(v.err for v in tot.values()), t)
                    # the float32 kernels on the same values
                    xf, wf, gf = x.float(), [v.float() for v in w], g.float()
                    gyf = None if g_y is None else g_y.float()
                    _of, qf, oaf, msf = cp.attn_proj_fwd(xf, *wf, dense, m,
                                                         scale, nh, True)
                    _of, ylf, qlf, olf, mslf = cp.attn_ln_proj_fwd(
                        xf, gm, bt, eps, *wf, dense, m, scale, nh, True)
                    add(f32, "proj_fwd", sites, graph_ms(
                        lambda: cp.attn_proj_fwd(xf, *wf, dense, m, scale,
                                                 nh)))
                    add(f32, "ln_proj_fwd", sites, graph_ms(
                        lambda: cp.attn_ln_proj_fwd(xf, gm, bt, eps, *wf,
                                                    dense, m, scale, nh)))
                    add(f32, "proj_bwd", sites, graph_ms(
                        lambda: cp.attn_proj_bwd(xf, qf, wf[0], wf[2], dense,
                                                 m, oaf, msf, gf, scale,
                                                 nh)))
                    add(f32, "ln_proj_bwd", sites, graph_ms(
                        lambda: cp.attn_ln_proj_bwd(
                            xf, ylf, qlf, gm, eps, wf[0], wf[2], dense, m,
                            olf, mslf, gf, gyf, scale, nh)))
                    del xf, wf, gf, gyf, _of, qf, oaf, msf, ylf, qlf, olf
                    del mslf
                    # what each must move (bfloat16 activations and
                    # weights, the float32 bias, mask and ms) and do
                    act, small = 2 * m_rows * c, (
                        2 * (4 * c * c + 4 * c) + 4 * dense.numel()
                        + (0 if m is None else 4 * m.numel()))
                    attn_f = b_ * nh * n_tok * n_tok * (4 * hd + 6)
                    attn_b = b_ * nh * n_tok * n_tok * (10 * hd + 12)
                    sizes = {
                        "proj_fwd": (2 * act + small,
                                     8 * m_rows * c * c + attn_f),
                        "ln_proj_fwd": (3 * act + small + 8 * c,
                                        8 * m_rows * c * c + attn_f
                                        + 8 * m_rows * c),
                        # x, qkv (3), o_att, g read, dx written; ms; the
                        # weights read, their gradients and dbias written
                        "proj_bwd": (7 * act + 8 * m_rows * nh + 2 * small,
                                     16 * m_rows * c * c + attn_b),
                        "ln_proj_bwd": (
                            (8 + (g_y is not None)) * act + 8 * m_rows * nh
                            + 2 * small + 16 * c,
                            16 * m_rows * c * c + attn_b + 20 * m_rows * c)}
                    per_site(t, {k: ({"proj_fwd": "proj",
                                      "ln_proj_fwd": "ln_proj",
                                      "proj_bwd": "proj bwd",
                                      "ln_proj_bwd": "ln_proj bwd"}[k],
                                     nb, fl,
                                     3 + ("ln" in k) if "fwd" in k
                                     else max(per_call[k]))
                                 for k, (nb, fl) in sizes.items()})
                    for key, label in (("proj_fwd", "proj"),
                                       ("ln_proj_fwd", "ln_proj"),
                                       ("proj_bwd", "proj bwd"),
                                       ("ln_proj_bwd", "ln_proj bwd")):
                        nb, fl = sizes[key]
                        lib = t.get(f"{label} library", (None, None))
                        tot[key].add(sites, ms=t[label][0],
                                     device_ms=t[label][1],
                                     plain_ms=t[f"{label} plain"][0],
                                     plain_device_ms=t[f"{label} plain"][1],
                                     library_ms=lib[0],
                                     library_device_ms=lib[1], bytes=nb,
                                     flops=fl)
                        add(comp, key, sites, t[f"{label} composition"][1])
                    del qkv_, o_att, ms_, y_ln, qkv_ln, o_ln, ms_ln, am, x_t
                    del pargs, largs
                del x, g, gy
    src, ops = "vitta_tpu_torch/csrc/attention_proj.cu", \
        "vitta_tpu/ops/pallas_attention.py"
    rows = [tot["proj_fwd"].row("attn_proj_fwd_bf16", src, f"{ops}:724",
                                flop_rate=BF16_FLOP_PER_S),
            tot["proj_bwd"].row("attn_proj_bwd_bf16", src, f"{ops}:747",
                                flop_rate=BF16_FLOP_PER_S),
            tot["ln_proj_fwd"].row("attn_ln_proj_fwd_bf16", src,
                                   f"{ops}:945", has_library=False,
                                   flop_rate=BF16_FLOP_PER_S),
            tot["ln_proj_bwd"].row("attn_ln_proj_bwd_bf16", src,
                                   f"{ops}:967", has_library=False,
                                   flop_rate=BF16_FLOP_PER_S)]
    for row, key in zip(rows, keys):
        row["float32_device_ms"] = f32[key]
        row["composition_device_ms"] = comp[key]
        if key in per_call:
            row["launches_per_call"] = sorted(per_call[key])
        print(f"{row['name']} per Swin-B pass of 2 clips (24 sites): device "
              f"ms kernel {fmt(row['device_ms'])} float32 kernel "
              f"{fmt(row['float32_device_ms'])} plain "
              f"{fmt(row['plain_device_ms'])} library "
              f"{fmt(row['library_device_ms'])} composition "
              f"{fmt(row['composition_device_ms'])}; event ms "
              f"{row['ms']:.4f} / {row['plain_ms']:.4f}; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} at bfloat16"
              + (f"; launches per call {row['launches_per_call']}"
                 if key in per_call else ""), flush=True)
    return rows


def phase_bf16_swin_modes(cfg, sd, stats, seed, card, mode,
                          n_videos=BF16_MODE_VIDEOS, warmup=1):
    """Phase 27 under the engine's other modes that vitta_tpu runs on Video
    Swin (BNS reads BatchNorm layers, of which it has none): Swin-B at
    bfloat16, drop-path 0.2 and head dropout 0.5, over ``n_videos`` seeded
    videos, ``mode`` "cossim" (``tta_stream`` with the relation-map targets
    of the float32 model over one clean batch of 2 clips) or
    "tta_epoch_adapt" (adapt-only steps on phase 9's source statistics,
    then one ``validate`` pass).  Every LayerNorm, attention and
    LayerNorm-MLP launch a bfloat16 instance, finite losses, a finite
    gradient on every float32 master; returns a summary of its times."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import tta_epoch_adapt, tta_stream
    from vitta_tpu_torch.adapt.precompute import compute_cossim_statistics
    t, hw = cfg.data.clip_length, cfg.data.input_size
    if mode == "cossim":
        cfg = cfg.replace(tta=dataclasses.replace(
            cfg.tta, stat_reg="cossim", stat_type=("temp",)))
        rng = np.random.default_rng(seed)
        batches = [(torch.from_numpy(c).cuda(), lb) for c, lb in
                   _normalized_batches(rng, cfg, (2,), t, hw)]
        stats = compute_cossim_statistics(
            _swin_model(cfg, sd), batches, clip_len=t,
            tap_filter=lambda n: "patch_embed" not in n)
        del batches
    engine = VittaEngine(_synthetic_swin(cfg, "bfloat16"), cfg, sd, stats)
    rng = np.random.default_rng(seed + 1)
    videos = _videos(rng, n_videos, t, hw)
    writer = _StepTimes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_swin_counts()
    box = {}

    def run():
        if mode == "cossim":
            (box["top1"],), box["state"], box["meters"] = tta_stream(
                engine, videos, seed=seed, metrics_writer=writer)
        else:
            box["top1"], box["state"] = tta_epoch_adapt(
                engine, videos, [(c, lb) for _v, c, lb in videos], seed=seed)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    names = launches_of(run)
    wall_ms = (time.perf_counter() - t0) * 1e3
    _bf16_swin_launches(names)
    counts = _swin_counts()
    state = box["state"]
    if state.step != n_videos or not any(counts.values()):
        raise AssertionError(f"swin-B bfloat16 ({mode}): {state.step} steps, "
                             f"launches {counts}")
    for k, m in box.get("meters", {}).items():
        if k.startswith("loss") and not np.isfinite(m.avg):
            raise AssertionError(f"swin-B bfloat16 ({mode}): {k} not finite")
    for k, p in engine.model.named_parameters():
        if p.dtype != torch.float32 or p.grad is None or not bool(
                torch.isfinite(p.grad).all()):
            raise AssertionError(f"swin-B bfloat16 ({mode}) {k}: no finite "
                                 "float32 gradient on a float32 master")
    # at lr 1e-5 a norm weight of 1 moves below float32's resolution
    moved = sum(not torch.equal(p.detach(), engine.init_params[k])
                for k, p in engine.model.named_parameters())
    if not moved:
        raise AssertionError(f"swin-B bfloat16 ({mode}): no parameter moved")
    ms = writer.ms[warmup:] if writer.ms else [wall_ms / n_videos]
    summary = {"model": "swin-B", "route": f"packed, {mode}",
               "dtype": "bfloat16", "videos": len(ms),
               "median_ms": statistics.median(ms), "min_ms": min(ms),
               "max_ms": max(ms),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"swin-B bfloat16 adapt full slice ({mode}): {n_videos} videos, "
          + (f"median {summary['median_ms']:.3f} ms/video after {warmup} "
             f"warm-up" if writer.ms else
             f"{wall_ms / n_videos:.3f} ms/video over the adapt-only steps "
             f"and the evaluation pass")
          + f", top1 {box['top1']:.1f}, {len(state.ema)} chosen layers, "
          f"{moved} parameter tensors moved, peak "
          f"memory {summary['peak_gib']:.3f} GiB, launches {counts}, bfloat16 "
          f"kernel instances "
          f"{sum(n for k, n in names.items() if _bf16_name(k))}; on {card}",
          flush=True)
    return summary


class _Waits:
    """Iterates ``items`` and keeps the host ms each step waited for its
    next item (the consumer's wait)."""

    def __init__(self, items):
        self.items, self.ms = items, []

    def __iter__(self):
        it = iter(self.items)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.ms.append((time.perf_counter() - t0) * 1e3)
            yield item


def _stream_record(engine, data, seed):
    """``tta_stream`` over ``data``; (each video's losses and prediction,
    the final parameters), read after the stream."""
    from vitta_tpu_torch.adapt.loops import tta_stream
    seen = []
    step = engine.adapt_eval_step

    def recording(state, views, clip, label, generator=None):
        state, m = step(state, views, clip, label, generator)
        seen.append(m)
        return state, m
    engine.adapt_eval_step = recording
    try:
        tta_stream(engine, data, seed=seed)
    finally:
        del engine.adapt_eval_step
    torch.cuda.synchronize()
    losses = torch.stack([torch.stack([m.loss_reg, m.loss_consis, m.loss_ce])
                          for m in seen]).double().cpu()
    preds = torch.cat([m.pred for m in seen]).cpu()
    params = {k: p.detach().clone() for k, p in engine.model.named_parameters()}
    return losses, preds, params


def _stream_spread(a, b):
    """(largest loss difference, predictions that differ, largest
    parameter difference) between two recorded streams."""
    return (float((a[0] - b[0]).abs().max()), int((a[1] != b[1]).sum()),
            max(float((a[2][k] - b[2][k]).abs().max()) for k in a[2]))


def phase_loader(card, what, cfg, engine, dataset_cls, seed=SEED):
    """Phase 39, for one model: the loader chain of vitta_tpu's
    main_eval.py (make_video_source -> PairedTTADataset(emit_uint8=True) ->
    Prefetcher -> tta_stream) on the card.  ``SyntheticVideoSource`` at
    UCF101's 240 x 320 frames, a list of one warm-up video and
    LOADER_VIDEOS more, the dataset of ``dataset_cls`` at the model's
    operating point, the ``Prefetcher`` staging each item in pinned memory
    and copying it on a stream of its own.

    The check: the stream fed by the loader gives the predictions, losses
    and final parameters of the same items fed from numpy arrays in memory,
    within the spread of two in-memory runs (exactly where they agree
    exactly); cuDNN's deterministic algorithms for the check.  The times,
    from runs apart from the check over a longer list (a warm-up video and
    LOADER_TIMED_VIDEOS more, so that the workers keep working beside the
    steps), in turns: ms/video of the in-memory feed and of the loader at 1
    and at min(8, usable cores) workers, the consumer's wait for the next
    item, the loader's host ms per item alone (one thread on cached frames,
    and through the Prefetcher with no engine), one item's host-to-device
    copy from pinned and from pageable memory."""
    from vitta_tpu_torch.adapt.loops import tta_stream
    from vitta_tpu_torch.data import native
    from vitta_tpu_torch.data.dataset import PairedTTADataset
    from vitta_tpu_torch.data.pipeline import Prefetcher
    from vitta_tpu_torch.data.records import VideoRecord
    from vitta_tpu_torch.data.video_reader import make_video_source
    t0 = time.perf_counter()
    lib = native.build_library("vitta_host")
    native.get_lib()
    if lib.parent != native.BUILD_DIR or not lib.is_file():
        raise AssertionError(f"{what} loader: the host library is {lib}")
    build_s = time.perf_counter() - t0
    src = make_video_source("synthetic", height=LOADER_FRAME[0],
                            width=LOADER_FRAME[1])
    classes = cfg.model.num_classes
    records = [VideoRecord(f"{what}_{i}", src.num_frames(f"{what}_{i}"),
                           i % classes)
               for i in range(1 + max(LOADER_VIDEOS, LOADER_TIMED_VIDEOS))]
    paired, timed = (PairedTTADataset(cfg, src, recs, seed=seed,
                                      dataset_cls=dataset_cls,
                                      emit_uint8=True)
                     for recs in (records[:1 + LOADER_VIDEOS], records))
    t0 = time.perf_counter()
    timed_items = [timed[i] for i in range(len(timed))]
    first_ms = (time.perf_counter() - t0) * 1e3 / len(timed_items)
    items = timed_items[:len(paired)]
    views, clip, label = items[0]
    want = ((2, cfg.data.clip_length, cfg.data.input_size,
             cfg.data.input_size, 3), np.uint8)
    if (views.shape, views.dtype) != want or clip.dtype != np.uint8 \
            or label.dtype != np.int32 or label.shape != (1,):
        raise AssertionError(f"{what} loader: items {views.shape} "
                             f"{views.dtype}, {clip.shape}, {label}")
    workers = min(8, len(os.sched_getaffinity(0)))

    # the check: the same items in memory twice, then through the loader
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mem_a = _stream_record(engine, items, seed)
        mem_b = _stream_record(engine, items, seed)
        fed = _stream_record(engine, Prefetcher(paired, n_workers=workers),
                             seed)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    spread, got = _stream_spread(mem_a, mem_b), _stream_spread(fed, mem_a)
    if any(g > s for g, s in zip(got, spread)):
        raise AssertionError(
            f"{what} loader: the loader-fed stream is (losses {got[0]:.3e}, "
            f"{got[1]} predictions, parameters {got[2]:.3e}) from the "
            f"in-memory one, beyond the in-memory runs' spread {spread}")
    if not (torch.isfinite(fed[0]).all() and mem_a[0][:, 0].min() > 0):
        raise AssertionError(f"{what} loader: losses {fed[0]}")

    # the times, apart from the check, the feeds in turns
    feeds = {"in memory": lambda: timed_items,
             "loader, 1 worker": lambda: Prefetcher(timed, n_workers=1),
             f"loader, {workers} workers": lambda: Prefetcher(
                 timed, n_workers=workers)}
    ms = {k: [] for k in feeds}
    waits = {k: [] for k in feeds}
    for _round in range(LOADER_ROUNDS):
        for name, make in feeds.items():
            writer, feed = _StepTimes(), _Waits(make())
            tta_stream(engine, feed, seed=seed, metrics_writer=writer)
            torch.cuda.synchronize()
            ms[name] += writer.ms[1:]
            waits[name] += feed.ms[1:]
    alone = {}
    for n in (1, workers):
        t0 = time.perf_counter()
        for _item in Prefetcher(timed, n_workers=n):
            pass
        torch.cuda.synchronize()
        alone[n] = (time.perf_counter() - t0) * 1e3 / len(timed)
    t0 = time.perf_counter()
    for i in range(len(timed)):
        timed[i]
    host_ms = (time.perf_counter() - t0) * 1e3 / len(timed)
    arrays = [a for a in items[1] if a.nbytes > 64]
    pinned = [torch.from_numpy(a).pin_memory() for a in arrays]

    def copy_ms(from_pinned):
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a, p in zip(arrays, pinned):
                (p.to("cuda", non_blocking=True) if from_pinned
                 else torch.from_numpy(a).to("cuda"))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    copy = {"pinned": copy_ms(True), "pageable": copy_ms(False)}
    mb = sum(a.nbytes for a in arrays) / 1e6
    print(f"{what} loader chain: PairedTTADataset({dataset_cls.__name__}, "
          f"emit_uint8) over SyntheticVideoSource{LOADER_FRAME} -> "
          f"Prefetcher(cuda, pinned, {workers} workers) -> tta_stream, "
          f"{len(paired)} videos: against the same items in memory, losses "
          f"{got[0]:.3e}, predictions differing {got[1]}, parameters "
          f"{got[2]:.3e} (the in-memory runs' spread {spread[0]:.3e}, "
          f"{spread[1]}, {spread[2]:.3e}); host library "
          f"{os.path.relpath(lib, ROOT)} ({build_s:.2f} s to build or "
          f"find); on {card}", flush=True)
    print(f"{what} loader times, {LOADER_ROUNDS} rounds of "
          f"{LOADER_TIMED_VIDEOS} videos after a warm-up, feeds in turns: "
          + "; ".join(f"{k} median {statistics.median(v):.3f} ms/video "
                      f"(min {min(v):.3f}, max {max(v):.3f}), the consumer's "
                      f"wait median {statistics.median(waits[k]):.3f} ms "
                      f"(max {max(waits[k]):.3f})" for k, v in ms.items())
          + f"; the loader alone: {host_ms:.3f} host ms per item on one "
          f"thread (the first pass {first_ms:.3f}), through the Prefetcher "
          + ", ".join(f"{v:.3f} ms per item at {n} worker{'s' * (n > 1)}"
                      for n, v in alone.items())
          + f"; one item's host-to-device copy ({mb:.2f} MB): pinned "
          f"{copy['pinned']:.3f} ms, pageable {copy['pageable']:.3f} ms; "
          f"host cores {os.cpu_count()}, usable "
          f"{len(os.sched_getaffinity(0))}; on {card}", flush=True)
    return {"ms": {k: statistics.median(v) for k, v in ms.items()},
            "wait_ms": {k: statistics.median(v) for k, v in waits.items()},
            "host_ms": host_ms, "prefetcher_ms": alone, "copy_ms": copy}


# ---------------------------------------------------------------------------
# phases 40-41: the baselines and the CLI
BASELINE_VIDEOS = 4       # phase 40's TANet stream for each baseline
BASELINE_SWIN_VIDEOS = 2  # its Swin-B stream (TENT and NORM)
DUA_NO_VIDS = 2           # DUA adapts on videos 0, 1 and 2 (i == no_vids)
SMALL_BASELINE_VIDEOS = 4  # the card-against-CPU baselines, 2 a batch
SWEEP_VIDEOS = 5          # phase 41: videos of each corruption
SWEEP_KILL = 3            # the second corruption's item that raises
BASELINES = ("source", "norm", "tent", "shot", "dua", "t3a")


def _quiet_logger():
    import logging
    logger = logging.getLogger("chip_smoke.cli")
    logger.setLevel(logging.WARNING)
    return logger


def _baseline_tam_calls(name, n, no_vids=DUA_NO_VIDS):
    """(forward, backward) TAM calls of one TANet baseline over ``n`` videos
    in batches of one: 16 (ResNet-50's TAM sites) a forward or backward
    pass.  TENT: an adaptation pass, then an evaluation pass; SHOT: the
    pseudo-label pass, an adaptation pass and an evaluation pass; DUA: for
    each of its no_vids + 1 adaptation videos one forward of the augmented
    batch and an evaluation pass."""
    fwd, bwd = {"source": (n, 0), "norm": (n, 0), "t3a": (n, 0),
                "tent": (2 * n, n), "shot": (3 * n, n),
                "dua": ((no_vids + 1) * (1 + n), 0)}[name]
    return 16 * fwd, 16 * bwd


def _tanet_library(library):
    """The float32 TAM kernels' launches from the libraries' counts:
    (forward, backward calls); a float32 backward call is two launches."""
    fwd = sum(n for k, n in library.items() if k.startswith("tam_fwd")
              and "bf16" not in k and "bfloat16" not in k)
    bwd = sum(n for k, n in library.items() if k.startswith("tam_bwd")
              and "bf16" not in k and "bfloat16" not in k)
    return fwd, bwd / 2


# the bounds on TENT's and SHOT's updates card against CPU: (median tensor,
# whole update, worst tensor), each a fraction of the update's norm.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W: TENT 0.056 / 0.080 /
# 0.49, SHOT 0.057 / 0.060 / 0.13.  Rounding alone gives as much: the CPU
# against itself from weights one ulp away (printed beside them) reads
# 0.053 / 0.085 / 0.53 and 0.054 / 0.054 / 0.12 on that machine's CPU, so
# phase 23's 2% median / 5% whole cannot hold here.  A fault reads well
# above the bounds: with a planted wrong BatchNorm (the unbiased variance
# in the normalization, or eps 1e-3) or batch statistics detached from the
# gradient, the CPU reads 1.15-3.0 / 0.94-4.3 / 1.8-16.6 against the
# correct CPU run.
BATCH_STAT_UPDATES = {"tent": (0.1, 0.15, 0.75), "shot": (0.1, 0.15, 0.75)}
# a tensor whose update on the CPU is within this many ulps of its weights
# is held only in the whole update: at SHOT's lr 5e-5 a BatchNorm weight of
# 1 moves by a few ulps, and its rounding decides the tensor's ratio
# (151 of SHOT's 273 moved tensors; the faults above read as much with
# them left out)
ULP_FLOOR = 64


def _fail(message):
    raise AssertionError(message)


def _one_ulp_away(sd, seed=1):
    """``sd`` with every float tensor moved by one float32 ulp, a seeded
    random sign an element."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        out[k] = v
        if v.is_floating_point():
            up = torch.rand(v.shape, generator=gen) < 0.5
            out[k] = v * (1.0 + torch.where(up, 1.0, -1.0) * 2.0 ** -23)
    return out


def _batch_stat_updates_agree(what, sd, p_gpu, p_cpu, median, whole, each):
    """Updates card against CPU where the gradients run through
    batch-statistics BatchNorm (TENT, SHOT), held as
    tests/test_torch_baselines.py holds TENT's against vitta_tpu's.  Those
    gradients are ill-conditioned at a size the CPU can run: one float32
    ulp of the weights moves the port's own by a median 0.5-0.9% a tensor
    and some tensors by 2-4%.  SGD's update follows the gradient (SHOT);
    Adam's first steps are about lr * sign(g), so an element whose gradient
    is rounding noise moves by lr either way (TENT).  So the median tensor's
    update is held within ``median`` of its norm, the whole update within
    ``whole``, each tensor that moved on the CPU by more than ULP_FLOOR
    ulps of its weights within ``each``, as ``_assert_bf16_slice`` holds
    phase 23's.  Returns the ratios (median, whole, worst), how many
    tensors they cover and how many more moved within the floor."""
    gaps, diffs, norms, floored = [], [], [], 0
    eps = torch.finfo(torch.float32).eps
    for k, p in p_cpu.items():
        dg, dc = p_gpu[k] - sd[k], p - sd[k]
        diff, norm = float((dg - dc).norm()), float(dc.norm())
        diffs.append(diff)
        norms.append(norm)
        if norm > ULP_FLOOR * eps * float(sd[k].norm()):
            gaps.append(diff / norm)
        elif norm > 0:
            floored += 1
    if not gaps:
        raise AssertionError(f"{what}: nothing moved")
    got = (float(np.median(gaps)), float(np.linalg.norm(diffs)
                                         / np.linalg.norm(norms)), max(gaps))
    if got[0] > median or got[1] > whole or got[2] > each:
        raise AssertionError(f"{what}: updates card against cpu (median, "
                             f"whole, worst) {got} of {len(gaps)} tensors "
                             f"({floored} more within {ULP_FLOOR} ulps), "
                             f"bounds {median}, {whole}, {each}")
    return tuple(round(g, 4) for g in got) + (len(gaps), floored)


def phase_baselines_small(seed=SEED, dropout=0.0):
    """Phase 40, card against CPU: each baseline at T=4, 64x64 (101
    classes, dropout 0) over SMALL_BASELINE_VIDEOS synthetic videos in
    batches of 2, from one seeded state dict, on the card and on the CPU;
    DUA with no_vids 2.  Held at phase 23's bounds: top-1 equal, eval-mode
    logits of the adapted model on one clip rtol 2e-3 / atol 2e-4, each
    parameter's update within 2% of its norm, but TENT's and SHOT's, whose
    gradients run through batch statistics: ``_batch_stat_updates_agree``
    (at phase 19's Adam bound, 10% each, one of TENT's tensors was 11.8%
    apart; at phase 23's, median 2% and whole 5%, SHOT's were 5.7% and
    6.0%).  Each layer's running statistics within 2e-3 of their
    largest magnitude: NORM, TENT and DUA update them from batch
    statistics, which amplify the convolutions' float32 differences.  The
    size is tests/test_torch_baselines.py's: at T=2, 32x32 layer4 sees 4
    values a channel, and there TENT's logits came out 1.5e-3 apart, card
    against CPU; here 32.  Dropout is 0 because the card's and the CPU's
    generators draw other masks from one seed: with the preset's dropout
    0.8 SHOT's updates are 1.33 of their norm apart (median tensor; NVIDIA
    H100 80GB HBM3, 700 W) and its logits 9.9e-3.
    The eval logits of the model as loaded, before any update, are held
    the same way, so that a forward fault shows apart from the updates.
    SHOT's pseudo-labels must be equal on both.  TENT and SHOT run a third
    time, on the CPU from weights one ulp away (``_one_ulp_away``); that
    run's gap to the CPU's, printed beside the card's, is what rounding
    alone gives.  ``dropout`` other than 0 shows what other masks give."""
    from vitta_tpu_torch.baselines import setup_baseline
    from vitta_tpu_torch.data.dataset import TANetVideoDataset
    from vitta_tpu_torch.data.records import VideoRecord
    from vitta_tpu_torch.data.video_reader import SyntheticVideoSource
    from vitta_tpu_torch.models import get_model
    cfg = _cfg(4, 101, dropout=dropout)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, input_size=64,
                                               scale_size=72))
    torch.manual_seed(seed)
    sd = {k: v.clone() for k, v in get_model(cfg).state_dict().items()}
    src = SyntheticVideoSource(96, 128)
    records = [VideoRecord(f"small_{i}", src.num_frames(f"small_{i}"), i % 7)
               for i in range(SMALL_BASELINE_VIDEOS)]
    eval_ds = TANetVideoDataset(cfg, src, records, dataset_type="eval")
    raw_ds = TANetVideoDataset(cfg, src, records, dataset_type="raw",
                               emit_uint8=True)
    probe = torch.from_numpy(eval_ds[0].frames)
    sd_ulp = _one_ulp_away(sd)
    lines, failed = [], []
    for name in BASELINES:
        runs = {}
        for run in ("cuda", "cpu") + (("cpu one ulp away",)
                                      if name in BATCH_STAT_UPDATES else ()):
            dev = run.split()[0]
            b = setup_baseline(name, get_model(cfg), cfg,
                               sd_ulp if run != dev else sd, device=dev,
                               **({"filter_k": 3} if name == "t3a" else {}))
            with torch.no_grad():
                before = b.model(probe.to(dev), None, train=False).cpu()
            pseudo = (b.pseudo_labels(eval_ds, 2).tolist()
                      if name == "shot" else None)
            top1 = (b.run(raw_ds, eval_ds, 2, no_vids=DUA_NO_VIDS, seed=seed)
                    if name == "dua" else b.run(eval_ds, 2))
            with torch.no_grad():
                logits = b.model(probe.to(dev), None, train=False).cpu()
            state = {k: v.detach().cpu().clone()
                     for k, v in b.model.state_dict().items()}
            runs[run] = (top1, logits, state, pseudo, before)
        ((t_gpu, l_gpu, s_gpu, pl_gpu, b_gpu),
         (t_cpu, l_cpu, s_cpu, pl_cpu, b_cpu)) = runs["cuda"], runs["cpu"]
        what = f"baseline {name} small"
        params = {k: s_cpu[k] for k, _p in get_model(cfg).named_parameters()}
        stats = [k for k in s_cpu if k.endswith(("running_mean",
                                                  "running_var"))]
        checks = {
            "top-1": lambda: t_gpu == t_cpu or _fail(
                f"{what}: top-1 card {t_gpu} cpu {t_cpu}"),
            # the model as loaded, before any update: a gap here is the
            # forward's, not the adaptation's
            "logits before the update": lambda: check_close(
                f"{what}, eval logits before the update", b_gpu, b_cpu, 2e-3,
                2e-4),

            "logits": lambda: check_close(f"{what}, eval logits", l_gpu,
                                          l_cpu, 2e-3, 2e-4),
            "running statistics": lambda: max(
                check_scaled(f"{what}, {k}", s_gpu[k], s_cpu[k], 2e-3)
                for k in stats),
            "updates (median, whole, worst; tensors, floored)": lambda: (
                _batch_stat_updates_agree(
                    what, sd, {k: s_gpu[k] for k in params}, params,
                    *BATCH_STAT_UPDATES[name])
                if name in BATCH_STAT_UPDATES else _assert_updates_agree(
                    what, sd, {k: s_gpu[k] for k in params}, params, 2e-2))}
        if name == "shot":
            checks["pseudo-labels equal"] = lambda: pl_gpu == pl_cpu or _fail(
                f"{what}: pseudo-labels card {pl_gpu} cpu {pl_cpu}")
        if name in BATCH_STAT_UPDATES:
            # what rounding alone gives: the CPU against itself from
            # weights one ulp away, each update taken from its own start
            s_ulp = runs["cpu one ulp away"][2]
            checks["cpu one ulp away (median, whole, worst; tensors, "
                   "floored)"] = lambda: _batch_stat_updates_agree(
                what, sd, {k: s_ulp[k] - (sd_ulp[k] - sd[k])
                           for k in params}, params, *(float("inf"),) * 3)
        got = []
        for check, fn in checks.items():
            try:
                got.append(f"{check} {fn()}")
            except AssertionError as e:
                failed.append(str(e))
                got.append(f"{check} FAILED")
        lines.append(f"{name}: " + ", ".join(got))
    print(f"baselines small (T=4, 64x64, dropout {dropout}) card vs cpu: "
          + "; ".join(lines),
          flush=True)
    if failed:
        raise AssertionError("; ".join(failed))


def _device_busy_ms(fn):
    """The summed device time of the kernels one call of ``fn`` launched,
    from torch.profiler; None where it records no kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.self_device_time_total > 0)
    return us / 1e3 if us > 0 else None


def phase_baselines(card, seed=SEED):
    """Phase 40: each of the six baselines through the port's
    ``cli.main_eval.evaluate`` (``tta=False``, ``--baseline``) on TANet at
    ``tanet_ucf101_preset`` (ResNet-50+TAM, 16 x 224 x 224, 101 classes,
    the CLI's seeded weights) over BASELINE_VIDEOS synthetic videos of
    UCF101's 240 x 320 frames (DUA with no_vids 2), and TENT and NORM on
    Swin-B (``swin_ucf101_preset``, packed, the CLI's seeded weights) over
    BASELINE_SWIN_VIDEOS.  The wrappers' counters must show every TAM call
    of a TANet run as a kernel launch, as many as the baseline's passes
    make, the libraries' own counts the same (so no plain version ran), and
    no BatchNorm-statistics launch (the baselines read no statistic tap).
    On Swin-B every forward pass launches phase 9's LayerNorm, bias,
    attention and LayerNorm-MLP kernels; TENT's backward, which autograd
    runs only as far as the norm layers' weights need it, every block's
    attention and LayerNorm-MLP backward and at most a LayerNorm backward
    and a bias collapse a site.
    Then the same evaluate again, timed: ms/video of the baseline's run
    (host clock, synchronised before and after; the model's construction
    apart) and the peak memory above what was held before; and a third
    time, the baseline's run under torch.profiler: the device's busy time
    a video."""
    from vitta_tpu_torch import baselines
    from vitta_tpu_torch.cli.main_eval import evaluate
    from vitta_tpu_torch.data.records import VideoRecord
    from vitta_tpu_torch.data.video_reader import SyntheticVideoSource
    from vitta_tpu_torch.ops import cuda_stats, cuda_tam
    src = SyntheticVideoSource()
    fwd_pass, bwd_pass = swin_launches("packed")
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for model, names, n in (("TANet", BASELINES, BASELINE_VIDEOS),
                                ("swin-B", ("tent", "norm"),
                                 BASELINE_SWIN_VIDEOS)):
            base = _cfg(16, 101) if model == "TANet" else _swin_cfg()
            records = [VideoRecord(f"{model}_b{i}", src.num_frames(
                f"{model}_b{i}"), i % 101) for i in range(n)]
            for name in names:
                cfg = base.replace(
                    tta=dataclasses.replace(base.tta, tta=False),
                    runtime=dataclasses.replace(
                        base.runtime, baseline=name, seed=seed,
                        result_dir=os.path.join(root, f"{model}_{name}")))
                times, busy_ms = [], []
                cls = baselines.BASELINES[name]

                class Timed(cls):
                    def run(self, *a, **k):
                        parent, got = super().run, {}
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        if len(times) < 2:
                            got["acc"] = parent(*a, **k)
                        else:   # the third run: the device's busy time
                            busy_ms.append(_device_busy_ms(
                                lambda: got.update(acc=parent(*a, **k))))
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t0) * 1e3)
                        return got["acc"]

                def call():
                    return evaluate(cfg, "synthetic", source_kind="synthetic",
                                    records=records, logger=_quiet_logger(),
                                    device="cuda", no_vids=DUA_NO_VIDS)

                baselines.BASELINES[name] = Timed
                try:
                    cuda_tam.counters.reset()
                    cuda_stats.counters.reset()
                    _reset_swin_counts()
                    box = {}
                    library = launches_of(lambda: box.update(rows=call()))
                    counts = ((cuda_tam.counters.fwd, cuda_tam.counters.bwd)
                              if model == "TANet" else _swin_counts())
                    bn = (cuda_stats.counters.fwd, cuda_stats.counters.bwd)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    held = torch.cuda.memory_allocated()
                    rows, state = call()
                    peak = torch.cuda.max_memory_allocated() - held
                    call()
                    busy = busy_ms[0]
                finally:
                    baselines.BASELINES[name] = cls
                top1 = box["rows"][0][0]
                if rows != box["rows"][0] or state is not None or not (
                        0.0 <= top1 <= 100.0):
                    raise AssertionError(f"{model} {name}: rows {rows} and "
                                         f"{box['rows']}")
                if bn != (0, 0):
                    raise AssertionError(f"{model} {name}: bn_stats launches "
                                         f"{bn}")
                if model == "TANet":
                    want = _baseline_tam_calls(name, n)
                    if counts != want or _tanet_library(library) != want:
                        raise AssertionError(
                            f"TANet {name}: TAM launches {counts} (the "
                            f"libraries' {_tanet_library(library)}), expected "
                            f"{want}")
                    shown = {"tam_fwd": counts[0], "tam_bwd": counts[1]}
                else:
                    passes_f, passes_b = (2 * n, n) if name == "tent" else (n, 0)
                    want = {k: v * passes_f for k, v in fwd_pass.items()}
                    most = {k: v * passes_b for k, v in bwd_pass.items()}
                    bwd = {k: counts[k] for k in most}
                    exact = ("attn_packed_bwd", "ln_mlp_bwd", "mlp_bwd",
                             "attn_heads_bwd", "attn_proj_bwd",
                             "attn_ln_proj_bwd")
                    if ({k: counts[k] for k in want} != want
                            or counts["contiguity_copies"]
                            or any(bwd[k] != most[k] for k in exact)
                            or any(bwd[k] > most[k] for k in most)
                            or bwd["ln_bwd"] < most["ln_bwd"] - passes_b):
                        raise AssertionError(
                            f"swin-B {name}: launches {counts}, expected "
                            f"forward {want} and backward up to {most}")
                    shown = {k: v for k, v in counts.items() if v}
                ms = times[1] / n
                out[f"{model} {name}"] = {"ms_per_video": ms,
                                          "busy_ms_per_video": fmt(
                                              busy and busy / n),
                                          "peak_gib": peak / 2**30,
                                          "launches": shown, "top1": top1}
                print(f"baseline {name} on {model} through evaluate: {n} "
                      f"videos, top-1 {top1:.1f}, {ms:.3f} ms/video (host "
                      f"clock, synchronised; the second of two runs), device "
                      f"busy {fmt(busy and busy / n)} ms/video (the "
                      f"baseline's run in a third, under torch.profiler), "
                      f"peak "
                      f"memory {peak / 2**30:.3f} GiB above the "
                      f"{held / 2**30:.3f} GiB held; launches {shown} (the "
                      f"libraries' counts the same, no bn_stats); on {card}",
                      flush=True)
    return out


def _carried(state):
    """CPU copies of everything a stream carries: parameters, BatchNorm
    buffers, momentum, EMA, step."""
    opt = state.optimizer
    return {
        "params": {k: p.detach().cpu().clone()
                   for k, p in state.params.items()},
        "buffers": {k: b.cpu().clone() for k, b in state.batch_stats.items()},
        "momentum": [opt.state[p]["momentum_buffer"].cpu().clone()
                     for g in opt.param_groups for p in g["params"]
                     if p in opt.state],
        "ema": {k: tuple(t.cpu().clone() for t in v)
                for k, v in state.ema.items()},
        "step": state.step}


def _carried_differ(a, b):
    """Names of the carried tensors that are not bit-equal."""
    out = [] if a["step"] == b["step"] else ["step"]
    for part in ("params", "buffers", "ema"):
        for k in a[part].keys() | b[part].keys():
            x, y = a[part].get(k), b[part].get(k)
            xs = x if isinstance(x, tuple) else (x,)
            ys = y if isinstance(y, tuple) else (y,)
            if x is None or y is None or not all(
                    torch.equal(p, q) for p, q in zip(xs, ys)):
                out.append(f"{part} {k}")
    if len(a["momentum"]) != len(b["momentum"]) or not all(
            torch.equal(p, q) for p, q in zip(a["momentum"], b["momentum"])):
        out.append("momentum")
    return out


class _DyingDataset:
    """A corruption's paired dataset that raises at item ``die_at``."""

    def __init__(self, paired, die_at):
        self._paired, self._die_at = paired, die_at

    def __len__(self):
        return len(self._paired)

    def __getitem__(self, i):
        if i == self._die_at:
            raise RuntimeError("simulated preemption")
        return self._paired[i]

    def __getattr__(self, name):
        return getattr(self._paired, name)


def phase_cli_resume(card, seed=SEED):
    """Phase 41: the CLI on the card.  ``run_compute_stats`` writes the
    source statistics of TANet (``tanet_ucf101_preset``, the CLI's seeded
    weights) over 4 synthetic videos of 240 x 320 frames in batches of 2;
    then ``run_corruption_sweep`` over two corruptions of SWEEP_VIDEOS
    videos each, mean_var from those files, ``--stream_ckpt_every 2``, the
    loader of phase 39 (2 workers).  One sweep runs through; another stops
    by an exception at item SWEEP_KILL of the second corruption (after its
    checkpoint at video 2) and is run again with ``--resume``: its rows,
    the second corruption's final parameters, BatchNorm buffers, momentum
    and EMA, and every video's logged losses and top-1 must be bit-equal to
    the uninterrupted sweep's.  cuDNN's deterministic algorithms, as phase
    39's check."""
    from vitta_tpu_torch.cli import drivers, main_eval
    from vitta_tpu_torch.data.records import VideoRecord
    from vitta_tpu_torch.data.video_reader import SyntheticVideoSource
    from vitta_tpu_torch.ops import cuda_stats, cuda_tam
    src = SyntheticVideoSource()
    records = [VideoRecord(f"sweep_{i}", src.num_frames(f"sweep_{i}"),
                           i % 101) for i in range(SWEEP_VIDEOS)]
    make, evaluate = main_eval.make_datasets, drivers.evaluate
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as root:
        base = _cfg(16, 101)
        stats_cfg = base.replace(
            data=dataclasses.replace(base.data, batch_size=2),
            runtime=dataclasses.replace(base.runtime, seed=seed,
                                        result_dir=root))
        cuda_stats.counters.reset()
        t0 = time.perf_counter()
        paths = main_eval.run_compute_stats(
            stats_cfg, source_kind="synthetic", records=records[:4],
            out_dir=os.path.join(root, "stats"), logger=_quiet_logger(),
            device="cuda")
        stats_s = time.perf_counter() - t0
        bn_fwd = cuda_stats.counters.fwd
        if bn_fwd == 0:
            raise AssertionError("compute_stats: no bn_stats launch")
        cfg = base.replace(
            data=dataclasses.replace(base.data, num_workers=2),
            tta=dataclasses.replace(base.tta,
                                    spatiotemp_mean_clean_file=paths[0],
                                    spatiotemp_var_clean_file=paths[1]),
            runtime=dataclasses.replace(base.runtime, seed=seed,
                                        stream_ckpt_every=2))

        def sweep(name, resume=False, die=False):
            run_cfg = cfg.replace(runtime=dataclasses.replace(
                cfg.runtime, resume=resume,
                result_dir=os.path.join(root, name)))
            states, made = {}, []

            def making(*a, **k):
                paired = make(*a, **k)
                made.append(1)
                return (_DyingDataset(paired, SWEEP_KILL)
                        if die and len(made) == 2 else paired)

            def recording(cfg_, corruption, **k):
                rows, state = evaluate(cfg_, corruption, **k)
                states[corruption] = _carried(state)
                return rows, state

            main_eval.make_datasets, drivers.evaluate = making, recording
            cuda_tam.counters.reset()
            cuda_stats.counters.reset()
            t0 = time.perf_counter()
            try:
                results = drivers.run_corruption_sweep(
                    run_cfg, ["gauss", "contrast"], source_kind="synthetic",
                    records=records, logger=_quiet_logger(), device="cuda")
            finally:
                main_eval.make_datasets, drivers.evaluate = make, evaluate
            seconds = time.perf_counter() - t0
            logged = {}
            for c in ("gauss", "contrast"):
                with open(os.path.join(root, name,
                                       f"metrics_{c}.jsonl")) as f:
                    for line in f:
                        rec = json.loads(line)
                        if rec["tag"] != "tta/step_ms":
                            logged[(c, rec["tag"], rec["step"])] = rec["value"]
            return results, states, logged, seconds, (
                cuda_tam.counters.fwd, cuda_tam.counters.bwd,
                cuda_stats.counters.fwd, cuda_stats.counters.bwd)

        try:
            want, want_states, want_logged, full_s, tam = sweep("full")
            try:
                sweep("cut", die=True)
                raise AssertionError("the cut sweep did not stop")
            except RuntimeError as e:
                if "simulated preemption" not in str(e):
                    raise
            with open(os.path.join(root, "cut", "stream_ckpt_contrast",
                                   "latest.json")) as f:
                next_bi = json.load(f)["next_bi"]
            got, got_states, got_logged, resume_s, _tam = sweep(
                "cut", resume=True)
        finally:
            torch.backends.cudnn.deterministic = deterministic
    differ = _carried_differ(got_states["contrast"], want_states["contrast"])
    if (got != want or differ or got_logged != want_logged
            or "gauss" in got_states or next_bi != 2):
        raise AssertionError(
            f"cli resume: rows {got} against {want}; carried tensors that "
            f"differ {differ[:5]} ({len(differ)}); logged values equal "
            f"{got_logged == want_logged}; checkpoint at video {next_bi}; "
            f"resumed corruptions {sorted(got_states)}")
    # per video 32 TAM forward (adapt and eval) and 16 backward launches,
    # one bn_stats launch each way at each of the 29 chosen layers
    videos = 2 * SWEEP_VIDEOS
    if tam != (32 * videos, 16 * videos, 29 * videos, 29 * videos):
        raise AssertionError(f"cli sweep: TAM and bn_stats launches {tam}")
    print(f"cli on {card}: run_compute_stats over 4 videos ({stats_s:.1f} s, "
          f"{bn_fwd} bn_stats launches) -> run_corruption_sweep over 2 "
          f"corruptions x {SWEEP_VIDEOS} videos (mean_var, "
          f"--stream_ckpt_every 2, 2 loader workers) in {full_s:.1f} s, "
          f"launches TAM forward / backward, bn_stats forward / backward "
          f"{tam}; a sweep stopped at item {SWEEP_KILL} "
          f"of the second corruption (checkpoint at video {next_bi}) and "
          f"resumed with --resume ({resume_s:.1f} s): rows {got}, the "
          f"second corruption's parameters, buffers, momentum and EMA and "
          f"{len(got_logged)} logged values bit-equal to the uninterrupted "
          f"sweep's", flush=True)
    return {"rows": got["mean"], "full_s": full_s, "resume_s": resume_s}


# ---------------------------------------------------------------------------
# Phases 42-45: the model zoo (VideoMAE ViT-B, R(2+1)D-18, I3D-ResNet 18 and
# 50, Inception-I3D, TANet without the TAM) and the Kinetics-400-C and SSv2-C
# drivers

ZOO_VIDEOS = 3         # each zoo model's full stream; the first is warm-up
ZOO_SMALL_T = {"i3d_incep": 8}   # frames of phase 43's clips (else 4)
# per video of a zoo stream under mean_var, written in PERF.md before the
# first run: the LayerNorms (25 taps: blocks_*.norm1/norm2 and norm, 25 in
# the adapt forward and 25 in the eval forward, 25 backward) and the 12
# MLPs (12 + 12 forward, 12 backward) of VideoMAE; one BatchNorm-statistics
# launch each way at each chosen BatchNorm (R(2+1)D 18, I3D-18 10, I3D-50
# 29, Inception 42, TANet without the TAM 29), none in the eval forward;
# nothing else of the port's kernels
ZOO_PREDICTED = {
    "videomae": dict(ln_fwd=50, ln_bwd=25, mlp_fwd=24, mlp_bwd=12),
    "r2plus1d": dict(bn_stats_fwd=18, bn_stats_bwd=18),
    "i3d_resnet18": dict(bn_stats_fwd=10, bn_stats_bwd=10),
    "i3d_resnet50": dict(bn_stats_fwd=29, bn_stats_bwd=29),
    "i3d_incep": dict(bn_stats_fwd=42, bn_stats_bwd=42),
    "tanet_no_tam": dict(bn_stats_fwd=29, bn_stats_bwd=29),
}
ZOO_COUNTERS = ("ln_fwd", "ln_bwd", "mlp_fwd", "mlp_bwd", "bn_stats_fwd",
                "bn_stats_bwd", "tam_fwd", "tam_bwd", "ln_mlp", "attention",
                "bias")
ZOO_BN_MODELS = ("r2plus1d", "i3d_resnet18", "i3d_resnet50", "i3d_incep",
                 "tanet_no_tam")
VIDEOMAE_ROWS = (3136, 1568)   # tokens of 2 views (adapt) and 1 clip (eval)


def _zoo_counts():
    """The wrappers' launch counts of every kernel family since the last
    ``_zoo_reset``."""
    from vitta_tpu_torch.ops import (cuda_attention, cuda_attention_proj,
                                     cuda_bias, cuda_ln, cuda_mlp, cuda_stats,
                                     cuda_tam)
    a, p = cuda_attention.counters, cuda_attention_proj.counters
    return {"ln_fwd": cuda_ln.counters.fwd, "ln_bwd": cuda_ln.counters.bwd,
            "mlp_fwd": cuda_mlp.counters.mlp_fwd,
            "mlp_bwd": cuda_mlp.counters.mlp_bwd,
            "bn_stats_fwd": cuda_stats.counters.fwd,
            "bn_stats_bwd": cuda_stats.counters.bwd,
            "tam_fwd": cuda_tam.counters.fwd, "tam_bwd": cuda_tam.counters.bwd,
            "ln_mlp": cuda_mlp.counters.fwd + cuda_mlp.counters.bwd,
            "attention": (a.fwd + a.bwd + a.heads_fwd + a.heads_bwd
                          + p.proj_fwd + p.proj_bwd + p.ln_proj_fwd
                          + p.ln_proj_bwd),
            "bias": cuda_bias.counters.fwd + cuda_bias.counters.bwd}


def _zoo_reset():
    from vitta_tpu_torch.ops import (cuda_attention, cuda_attention_proj,
                                     cuda_bias, cuda_ln, cuda_mlp, cuda_stats,
                                     cuda_tam)
    from vitta_tpu_torch.ops._launch import copy_counters
    for mod in (cuda_attention, cuda_attention_proj, cuda_bias, cuda_ln,
                cuda_mlp, cuda_stats, cuda_tam):
        mod.counters.reset()
    copy_counters.reset()


def zoo_bn_sites(dev):
    """{model: {(rows, C, eps): [calls a forward pass, chosen calls]}} of
    every BatchNorm of the zoo's CNNs on the adapt batch (2 views of 16 x
    224 x 224), read from one untapped forward on the card; "chosen" are
    the calls at the layers the model's ``--chosen_blocks`` select, where a
    mean_var step runs the BatchNorm-statistics kernels."""
    from vitta_tpu_torch.adapt.engine import select_tap_names
    from vitta_tpu_torch.models.layers import BatchNorm
    from vitta_tpu_torch.tools.synthetic import ZOO_MODELS, zoo_cfg, zoo_model
    out = {}
    x = torch.zeros(2, 16, 224, 224, 3, device=dev)
    for name in ZOO_BN_MODELS:
        cfg = zoo_cfg(name)
        model = zoo_model(name, cfg).to(dev)
        names = [m.tap_name for m in model.modules()
                 if isinstance(m, BatchNorm)]
        chosen = set(select_tap_names(names, ZOO_MODELS[name][1]))
        sites, hooks = {}, []

        def hook(mod, args):
            key = (args[0].numel() // mod.features, mod.features, mod.eps)
            slot = sites.setdefault(key, [0, 0])
            slot[0] += 1
            slot[1] += mod.tap_name in chosen
        for m in model.modules():
            if isinstance(m, BatchNorm):
                hooks.append(m.register_forward_pre_hook(hook))
        with torch.no_grad():
            model(x, None)
        for h in hooks:
            h.remove()
        out[name] = sites
        del model
    torch.cuda.empty_cache()
    return out


def phase_zoo_kernels(dev):
    """Phase 42: the kernels of the model zoo's path against their plain
    versions at the shapes and widths no earlier phase runs: the float32
    LayerNorm forward and backward (rows 3-4) at VideoMAE's (3136, 768) and
    (1568, 768), the MLP without the LayerNorm (rows 8-9) at (3136, 768,
    3072), and the BatchNorm-statistics pair (row 7) at every BatchNorm
    site of R(2+1)D-18, I3D-ResNet 18 and 50, Inception-I3D (eps 1e-3) and
    TANet without the TAM on the adapt batch, with their real row counts:
    y, m, v, dx, dscale, dbias at phase 18's tolerances, one launch a call
    each way, naming the instance that ran (``<1, ...>`` one column a
    thread where C is odd or 2 mod 4: R(2+1)D's 45, 230, 460 and 921; ``<4,
    ...>`` 16-byte units otherwise).  Times (event and device ms) of kernel,
    plain version and, where one exists, the library call; returns the
    JSON rows, each summed over one pass of its model: VideoMAE's adapt
    forward (25 LayerNorms at 3136 rows, 12 MLPs) or backward; a CNN's
    chosen BatchNorms on the adapt batch."""
    import torch.nn.functional as F
    from vitta_tpu_torch.ops import cuda_ln as cl
    from vitta_tpu_torch.ops import cuda_mlp as cm
    from vitta_tpu_torch.ops.cuda_stats import (
        bn_stats_bwd_cuda, bn_stats_fwd_cuda,
        fused_bn_relu_stats_backward_reference,
        fused_bn_relu_stats_reference)
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def quick(fn, grad=False):
        return measure(fn, reps=5, dev_reps=3, grad=grad)

    src, ops = "vitta_tpu_torch/csrc", "vitta_tpu/ops"
    rows = []
    # rows 3 and 4 at VideoMAE's width: 25 LayerNorms a pass
    ln_f, ln_b = Totals(), Totals()
    c = 768
    for m_rows in VIDEOMAE_ROWS:
        x = randn(m_rows, c, scale=2.0) + 0.5
        g, b, dy = randn(c), randn(c), randn(m_rows, c)
        what = f"ln videomae rows={m_rows} C={c}"
        e_f = check_close(f"{what} fwd", cl.ln_fwd_cuda(x, g, b, 1e-5),
                          cl.layer_norm_reference(x, g, b, 1e-5), LN_TOL)
        got = cl.ln_bwd_cuda(x, g, dy, 1e-5)
        want = cl.layer_norm_backward_reference(x, g, dy, 1e-5)
        e_b = max(check_scaled(f"{what} {nm}", p, q, LN_BWD_TOL)
                  for nm, p, q in zip(("dx", "dgamma", "dbeta"), got, want))
        if not all(torch.equal(p, q) for p, q in
                   zip(got, cl.ln_bwd_cuda(x, g, dy, 1e-5))):
            raise AssertionError(f"{what}: two backward runs differ")
        names = {d: launches_of(fn) for d, fn in (
            ("fwd", lambda: cl.ln_fwd_cuda(x, g, b, 1e-5)),
            ("bwd", lambda: cl.ln_bwd_cuda(x, g, dy, 1e-5)))}
        if sum(names["fwd"].values()) != 1 or sum(names["bwd"].values()) != 2:
            raise AssertionError(f"{what}: launches {names}, expected 1 "
                                 "forward and 2 backward a call")
        leaves = [v.clone().requires_grad_() for v in (x, g, b)]
        y_lib = F.layer_norm(leaves[0], (c,), leaves[1], leaves[2], 1e-5)
        t = {"fwd": quick(lambda: cl.ln_fwd_cuda(x, g, b, 1e-5)),
             "fwd plain": quick(lambda: cl.layer_norm_reference(x, g, b,
                                                                1e-5)),
             "F.layer_norm": quick(lambda: F.layer_norm(x, (c,), g, b, 1e-5)),
             "bwd": quick(lambda: cl.ln_bwd_cuda(x, g, dy, 1e-5)),
             "bwd plain": quick(lambda: cl.layer_norm_backward_reference(
                 x, g, dy, 1e-5)),
             "F.layer_norm backward": quick(lambda: torch.autograd.grad(
                 y_lib, leaves, dy, retain_graph=True), grad=True)}
        _report(f"{what} (launches {names})", max(e_f, e_b), t)
        ln_f.err, ln_b.err = max(ln_f.err, e_f), max(ln_b.err, e_b)
        if m_rows == VIDEOMAE_ROWS[0]:
            ln_f.add(25, ms=t["fwd"][0], device_ms=t["fwd"][1],
                     plain_ms=t["fwd plain"][0],
                     plain_device_ms=t["fwd plain"][1],
                     library_ms=t["F.layer_norm"][0],
                     library_device_ms=t["F.layer_norm"][1],
                     bytes=(2 * x.numel() + 2 * c) * 4, flops=8 * x.numel())
            ln_b.add(25, ms=t["bwd"][0], device_ms=t["bwd"][1],
                     plain_ms=t["bwd plain"][0],
                     plain_device_ms=t["bwd plain"][1],
                     library_ms=t["F.layer_norm backward"][0],
                     library_device_ms=t["F.layer_norm backward"][1],
                     bytes=(3 * x.numel() + 3 * c) * 4, flops=14 * x.numel())
        del x, dy, got, want, leaves, y_lib
    rows += [ln_f.row("ln_fwd_videomae", f"{src}/ln.cu",
                      f"{ops}/pallas_ln.py:85"),
             ln_b.row("ln_bwd_videomae", f"{src}/ln.cu",
                      f"{ops}/pallas_ln.py:100")]

    # rows 8 and 9 at VideoMAE's width: 12 MLPs a pass
    m_rows, f = VIDEOMAE_ROWS[0], 3072
    w1, b1 = randn(f, c, scale=c ** -0.5), 0.1 * randn(f)
    w2, b2 = randn(c, f, scale=f ** -0.5), 0.1 * randn(c)
    x, g = randn(m_rows, c, scale=1.5), randn(m_rows, c)
    what = f"mlp videomae M={m_rows} C={c} F={f}"
    got = cm.mlp_fwd_cuda(x, w1, b1, w2, b2, save_residuals=True)
    want = cm.mlp_reference(x, w1, b1, w2, b2, save_residuals=True)
    e_f = max(check_close(f"{what} fwd {nm}", p, q, MLP_TOL)
              for nm, p, q in zip(("o", "a", "s"), got, want))
    _o, a, s_ = got
    args = (x, a, s_, g, w1, w2)
    got_b = cm.mlp_bwd_cuda(*args)
    e_b = max(check_scaled(f"{what} bwd {nm}", p, q, MLP_BWD_TOL)
              for nm, p, q in zip(("dx", "dw1", "db1", "dw2", "db2"), got_b,
                                  cm.mlp_backward_reference(*args)))
    if not all(torch.equal(p, q)
               for p, q in zip(cm.mlp_bwd_cuda(*args), got_b)):
        raise AssertionError(f"{what}: two backward runs differ")
    names = {d: launches_of(fn) for d, fn in (
        ("fwd", lambda: cm.mlp_fwd_cuda(x, w1, b1, w2, b2)),
        ("bwd", lambda: cm.mlp_bwd_cuda(*args)))}
    leaves = [v.detach().clone().requires_grad_()
              for v in (x, w1, b1, w2, b2)]
    with torch.enable_grad():
        o_lib = cm.mlp_reference(*leaves)
    t = {"fwd": quick(lambda: cm.mlp_fwd_cuda(x, w1, b1, w2, b2)),
         "fwd keeping a, s": quick(lambda: cm.mlp_fwd_cuda(
             x, w1, b1, w2, b2, save_residuals=True)),
         "fwd plain (F.linear-gelu-F.linear)": quick(
             lambda: cm.mlp_reference(x, w1, b1, w2, b2)),
         "bwd": quick(lambda: cm.mlp_bwd_cuda(*args)),
         "bwd plain": quick(lambda: cm.mlp_backward_reference(*args)),
         "bwd of the composition": quick(lambda: torch.autograd.grad(
             o_lib, leaves, g, retain_graph=True), grad=True)}
    _report(f"{what} (launches {names})", max(e_f, e_b), t)
    mlp_f, mlp_b = Totals(), Totals()
    mlp_f.err, mlp_b.err = e_f, e_b
    flops, bflops = 4 * m_rows * c * f + 10 * m_rows * f, \
        8 * m_rows * c * f + 4 * m_rows * f
    plain = t["fwd plain (F.linear-gelu-F.linear)"]
    mlp_f.add(12, ms=t["fwd keeping a, s"][0],
              device_ms=t["fwd keeping a, s"][1], plain_ms=plain[0],
              plain_device_ms=plain[1],
              bytes=(2 * m_rows * c + 2 * m_rows * f + 2 * c * f + f + c) * 4,
              flops=flops, tc_flops=4 * m_rows * c * f)
    mlp_b.add(12, ms=t["bwd"][0], device_ms=t["bwd"][1],
              plain_ms=t["bwd plain"][0], plain_device_ms=t["bwd plain"][1],
              library_ms=t["bwd of the composition"][0],
              library_device_ms=t["bwd of the composition"][1],
              bytes=(3 * m_rows * c + 2 * m_rows * f + 4 * c * f + f + c) * 4,
              flops=bflops, tc_flops=8 * m_rows * c * f)
    rows += [mlp_f.row("mlp_fwd_videomae", f"{src}/mlp.cu",
                       f"{ops}/pallas_mlp.py:209", has_library=False),
             mlp_b.row("mlp_bwd_videomae", f"{src}/mlp.cu",
                       f"{ops}/pallas_mlp.py:228", has_library=False)]
    rows[-2]["composition_device_ms"] = rows[-2]["plain_device_ms"]
    rows[-1]["composition_device_ms"] = mlp_b.sum["library_device_ms"]
    del x, g, a, s_, args, got, want, got_b, leaves, o_lib, w1, w2

    # row 7 at every BatchNorm site of the zoo's CNNs
    sites = zoo_bn_sites(dev)
    timed = {}
    for model, per_site in sites.items():
        tot = {"fwd": Totals(), "bwd": Totals()}
        instances = {}
        for (r, c, eps), (calls, chosen) in sorted(per_site.items()):
            key = (r, c, eps)
            x = randn(r, c, scale=2.0) + 0.5
            scale = torch.rand(c, device=dev, generator=gen) + 0.5
            bias, mean = randn(c), 0.1 * randn(c)
            var = torch.rand(c, device=dev, generator=gen) + 0.5
            cots = (randn(r, c), randn(c), randn(c))
            y, m, v = bn_stats_fwd_cuda(x, scale, bias, mean, var, eps, False)
            ry, (rm, rv) = fused_bn_relu_stats_reference(
                x, scale, bias, mean, var, eps=eps, relu=False)
            what = f"bn_stats {model} rows={r} C={c} eps={eps:g}"
            e_f = max(check_close(f"{what} y", y, ry, BN_TOL),
                      check_close(f"{what} m", m, rm, BN_TOL, 1e-6),
                      check_close(f"{what} v", v, rv, 1e-4, 1e-5))
            got = bn_stats_bwd_cuda(x, scale, bias, mean, var, m, *cots, eps,
                                    False)
            want = fused_bn_relu_stats_backward_reference(
                x, scale, bias, mean, var, rm, *cots, eps=eps, relu=False)
            e_b = max(check_scaled(f"{what} {nm}", p, q, BN_BWD_TOL)
                      for nm, p, q in zip(("dx", "dscale", "dbias"), got,
                                          want))
            names = {}
            for d, fn in (("fwd", lambda: bn_stats_fwd_cuda(
                    x, scale, bias, mean, var, eps, False)),
                    ("bwd", lambda: bn_stats_bwd_cuda(
                        x, scale, bias, mean, var, m, *cots, eps, False))):
                names[d] = launches_of(fn)
                if (sum(names[d].values()) != 1
                        or not all(k.startswith(f"bn_stats_{d}_kernel")
                                   for k in names[d])):
                    raise AssertionError(f"{what}: {d} launches {names[d]}, "
                                         f"expected one bn_stats_{d}_kernel")
            inst = "/".join(k[len("bn_stats_"):] for d in ("fwd", "bwd")
                            for k in names[d])
            instances.setdefault(inst, []).append(c)
            for d, e in (("fwd", e_f), ("bwd", e_b)):
                tot[d].err = max(tot[d].err, e)
            line = (f"{what}: {calls} calls a pass ({chosen} chosen), max abs "
                    f"err fwd {e_f:.2e} bwd {e_b:.2e}, instances {inst}")
            if chosen:
                if key not in timed:
                    ref_in = [t_.clone().requires_grad_()
                              for t_ in (x, scale, bias)]
                    ref_out = fused_bn_relu_stats_reference(
                        *ref_in, mean, var, eps=eps, relu=False)
                    ref_out = (ref_out[0], *ref_out[1])
                    timed[key] = {
                        "fwd": quick(lambda: bn_stats_fwd_cuda(
                            x, scale, bias, mean, var, eps, False)),
                        "bwd": quick(lambda: bn_stats_bwd_cuda(
                            x, scale, bias, mean, var, m, *cots, eps,
                            False)),
                        "plain_fwd": quick(
                            lambda: fused_bn_relu_stats_reference(
                                x, scale, bias, mean, var, eps=eps,
                                relu=False)),
                        "plain_bwd": quick(lambda: torch.autograd.grad(
                            ref_out, ref_in, cots, retain_graph=True),
                            grad=True)}
                    del ref_in, ref_out
                tm = timed[key]
                n = r * c
                for d, nb, fl in (("fwd", (2 * n + 6 * c) * 4, 6 * n),
                                  ("bwd", (3 * n + 10 * c) * 4, 12 * n)):
                    tot[d].add(chosen, ms=tm[d][0], device_ms=tm[d][1],
                               plain_ms=tm[f"plain_{d}"][0],
                               plain_device_ms=tm[f"plain_{d}"][1],
                               bytes=nb, flops=fl)
                line += ("; device us fwd / bwd "
                         f"{fmt(tm['fwd'][1] and tm['fwd'][1] * 1e3)} / "
                         f"{fmt(tm['bwd'][1] and tm['bwd'][1] * 1e3)}")
            print(line, flush=True)
            del x, cots, y, m, v, ry, rm, rv, got, want
        print(f"bn_stats {model}: {sum(n for n, _ in per_site.values())} "
              f"BatchNorm calls a forward pass at {len(per_site)} shapes, "
              f"{sum(ch for _, ch in per_site.values())} chosen; instances "
              f"by width: " + "; ".join(f"{k} at C {sorted(set(v))}"
                                        for k, v in instances.items()),
              flush=True)
        for d in ("fwd", "bwd"):
            rows.append(tot[d].row(f"bn_stats_{d}_{model}",
                                   f"{src}/bn_stats.cu",
                                   f"{ops}/pallas_stats.py:80",
                                   has_library=False))
            rows[-1]["instances"] = sorted(instances)
    for r in rows:
        print(f"{r['name']} per pass: event ms {r['ms']:.4f}, device ms "
              f"{fmt(r['device_ms'])}, plain {r['plain_ms']:.4f} (device "
              f"{fmt(r['plain_device_ms'])}), library "
              f"{fmt(r['library_ms'])} (device "
              f"{fmt(r['library_device_ms'])}), bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}{_floor(r)}", flush=True)
    torch.cuda.empty_cache()
    return rows


def phase_zoo_small(seed=SEED):
    """Phase 43, card against CPU for each zoo model at T=4, 32 x 32
    (Inception at T=8; 101 classes, dropout and drop path 0, lr 1e-2):
    from one seeded state dict and one clean clip's source statistics, a
    tapped forward (logits and every tap), then one ``tta_online``
    adapt+eval step each: losses, the EMA, the adapted model's eval logits,
    each parameter's update and top-1.  Phase 40's bounds: top-1 equal,
    logits rtol 2e-3 / atol 2e-4, each update within 2% of its norm; the
    taps and the EMA at phase 5's rtol 1e-3 / atol 1e-5 of the statistics
    (phase 40 reads the running statistics the same way)."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.models.layers import flatten_taps
    from vitta_tpu_torch.tools.synthetic import (ZOO_MODELS, zoo_cfg,
                                                 zoo_model, zoo_weights)
    lines = []
    for name in ZOO_MODELS:
        t = ZOO_SMALL_T.get(name, 4)
        cfg = zoo_cfg(name, t=t, hw=32)
        cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, lr=1e-2))
        sd = zoo_weights(name, cfg, seed)
        rng = np.random.default_rng(seed)
        clean = torch.from_numpy(rng.normal(size=(2, t, 32, 32, 3)).astype(
            np.float32))
        video = _videos(rng, 1, t, 32)[0]
        runs = {}
        for dev in ("cuda", "cpu"):
            model = zoo_model(name, cfg, deterministic=True)
            model.load_state_dict(sd)
            model.to(dev)
            taps = {}
            with torch.no_grad():
                logits = model(clean.to(dev), taps).cpu()
            stats = {k: (s.mean.cpu(), s.var.cpu())
                     for k, s in flatten_taps(taps).items()}
            runs[dev] = [logits, stats]
        src = {k: (m.numpy(), v.numpy()) for k, (m, v) in
               runs["cpu"][1].items()}
        for dev in ("cuda", "cpu"):
            eng = VittaEngine(zoo_model(name, cfg, deterministic=True), cfg,
                              sd, src, device=dev)
            state, m = eng.adapt_eval_step(eng.init_state(), *video)
            runs[dev] += [
                {f: float(getattr(m, f)) for f in
                 ("loss_reg", "loss_consis", "loss_ce", "top1")},
                eng.eval_logits(video[1]).cpu(),
                {k: p.detach().cpu() for k, p in eng.model.named_parameters()},
                {k: (s.mean.cpu(), s.var.cpu()) for k, s in state.ema.items()},
                len(eng.tap_names)]
        (l_g, s_g, m_g, el_g, p_g, e_g, chosen), \
            (l_c, s_c, m_c, el_c, p_c, e_c, _n) = runs["cuda"], runs["cpu"]
        what = f"zoo small {name} (T={t}, 32x32)"
        err = check_close(f"{what} logits", l_g, l_c, 2e-3, 2e-4)
        if set(s_g) != set(s_c) or not s_c:
            raise AssertionError(f"{what}: tap names differ")
        tap_err = max(check_close(f"{what} tap {k}", g, c_, 1e-3, 1e-5)
                      for k in s_c for g, c_ in zip(s_g[k], s_c[k]))
        for f in ("loss_reg", "loss_consis", "loss_ce"):
            if not abs(m_g[f] - m_c[f]) <= 1e-5 + 1e-3 * abs(m_c[f]):
                raise AssertionError(f"{what}: {f} card {m_g[f]} cpu "
                                     f"{m_c[f]}")
        if m_g["top1"] != m_c["top1"]:
            raise AssertionError(f"{what}: top-1 card {m_g['top1']} cpu "
                                 f"{m_c['top1']}")
        eval_err = check_close(f"{what} eval logits", el_g, el_c, 2e-3, 2e-4)
        ema_err = max(check_close(f"{what} ema {k}", g, c_, 1e-3, 1e-5)
                      for k in e_c for g, c_ in zip(e_g[k], e_c[k]))
        worst, moved = _assert_updates_agree(what, sd, p_g, p_c, 2e-2)
        if moved == 0:
            raise AssertionError(f"{what}: no parameter moved")
        lines.append(f"{name}: logits {err:.2e}, {len(s_c)} taps {tap_err:.2e}"
                     f", losses {m_g} vs {m_c}, eval logits {eval_err:.2e}, "
                     f"EMA of {chosen} layers {ema_err:.2e}, {moved} "
                     f"parameters moved, worst update {worst:.2e} of its norm")
    print("zoo small card vs cpu: " + "; ".join(lines), flush=True)


def _activation_copies(model, x):
    """The clones and copies one untapped forward of ``model`` on ``x``
    dispatches (``conv_ndhwc`` hands cuDNN channels_last_3d views and
    takes its output back as a view: none is expected)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.copies = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(k in str(func) for k in ("clone", "copy", "contiguous")):
                self.copies.append(str(func))
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Ops() as ops:
        model(x, None)
    return ops.copies


def phase_zoo_full(card, seed=SEED):
    """Phase 44: each zoo model at full width (VideoMAE ViT-B, R(2+1)D-18,
    I3D-ResNet 18 and 50, Inception-I3D, TANet without the TAM; 101
    classes, 2 views x 16 x 224 x 224, seeded weights, each model's source
    statistics from one clean clip) through ``tta_stream`` over ZOO_VIDEOS
    synthetic uint8 videos under mean_var, ``tta_online``, SGD at the TANet
    preset's lr, dropout and drop path as built.  The wrappers' launch
    counts of every kernel family must equal ZOO_PREDICTED times the
    videos; the libraries' own counts are printed beside them; one
    untapped forward of a CNN dispatches no clone or copy
    (``_activation_copies``: the convs take and give channels-last views).
    Then one
    profiled step: host ms, device busy ms, idle share, by class of kernel.
    Returns {model: (counts, summary)}."""
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import tta_stream
    from vitta_tpu_torch.ops._launch import copy_counters
    from vitta_tpu_torch.tools.synthetic import (ZOO_MODELS, zoo_cfg,
                                                 zoo_model, zoo_weights)
    out = {}
    for name in ZOO_MODELS:
        cfg = zoo_cfg(name)
        sd = zoo_weights(name, cfg, seed)
        rng = np.random.default_rng(seed)
        model = zoo_model(name, cfg)
        model.load_state_dict(sd)
        clean = torch.from_numpy(rng.normal(
            size=(2, 16, 224, 224, 3)).astype(np.float32)).cuda()
        src = _tanet_source(model.cuda(), clean)
        # the CNNs' convs: none (VideoMAE's plain attention reshapes the
        # heads' transposed outputs, as vitta_tpu's einsums do)
        copies_fwd = (_activation_copies(model, clean)
                      if name in ZOO_BN_MODELS else [])
        if copies_fwd:
            raise AssertionError(f"zoo {name}: a forward dispatched the "
                                 f"copies {copies_fwd}")
        del model, clean
        engine = VittaEngine(zoo_model(name, cfg), cfg, sd, src)
        videos = _videos(rng, ZOO_VIDEOS, 16, 224)
        writer = _StepTimes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zoo_reset()
        box = {}

        def run():
            top1, box["state"], box["meters"] = tta_stream(
                engine, videos, seed=seed, metrics_writer=writer)
            torch.cuda.synchronize()
        library = launches_of(run)
        counts = _zoo_counts()
        copies = copy_counters.contiguity_copies
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {k: ZOO_PREDICTED[name].get(k, 0) * ZOO_VIDEOS
                for k in ZOO_COUNTERS}
        if counts != want:
            raise AssertionError(f"zoo {name}: launches {counts}, predicted "
                                 f"{want}")
        state, meters = box["state"], box["meters"]
        for k in ("loss_reg", "loss_consis", "loss_ce"):
            if not np.isfinite(meters[k].avg):
                raise AssertionError(f"zoo {name}: {k} {meters[k].avg}")
        if not meters["loss_reg"].avg > 0 or state.step != ZOO_VIDEOS:
            raise AssertionError(f"zoo {name}: reg loss "
                                 f"{meters['loss_reg'].avg}, {state.step} "
                                 "steps")
        moved = sum(not torch.equal(p.detach(), engine.init_params[k])
                    for k, p in engine.model.named_parameters())
        if moved == 0 or not all(bool(torch.isfinite(p).all())
                                 for p in engine.model.parameters()):
            raise AssertionError(f"zoo {name}: {moved} tensors moved, or one "
                                 "is not finite")
        ms = writer.ms[1:]
        summary = {"model": name, "videos": len(ms),
                   "chosen": len(engine.tap_names),
                   "median_ms": statistics.median(ms), "min_ms": min(ms),
                   "max_ms": max(ms), "peak_gib": peak,
                   "contiguity_copies": copies}
        host_ms, busy, classes, largest = _profile_step(engine, videos[-1],
                                                        state)
        if busy:
            summary.update(host_ms=host_ms, device_busy_ms=busy,
                           idle_share=max(0.0, 1 - busy / host_ms))
        ours = {k: n for k, n in library.items()
                if k.startswith(("ln_", "mlp", "gemm", "reduce", "bn_stats",
                                 "tam_", "attn", "bias", "dbias", "col_"))}
        print(f"zoo full {name}: {ZOO_VIDEOS} videos, {summary['chosen']} "
              f"chosen layers, median {summary['median_ms']:.3f} ms/video "
              f"(min {summary['min_ms']:.3f}, max {summary['max_ms']:.3f}; "
              f"host clock, after 1 warm-up), device busy "
              f"{fmt(summary.get('device_busy_ms'))} ms of a profiled step "
              f"(host {host_ms:.3f} ms, idle share "
              f"{fmt(summary.get('idle_share'))}), peak memory {peak:.3f} "
              f"GiB, losses reg {meters['loss_reg'].avg:.5f} consis "
              f"{meters['loss_consis'].avg:.5f}, {moved} tensors moved; "
              f"wrapper launches {counts} (predicted, per video "
              f"{ZOO_PREDICTED[name]}), contiguity copies {copies}, "
              f"clones or copies in a CNN's forward 0; the "
              f"libraries' launches by kernel {ours}; by class, ms "
              f"(launches): " + ", ".join(f"{k} {v[0]:.3f} ({v[1]})"
                                          for k, v in classes.items())
              + f"; on {card}", flush=True)
        out[name] = (counts, summary)
        del engine, state, box
        torch.cuda.empty_cache()
    return out


def phase_zoo_drivers(card, seed=SEED):
    """Phase 45: the Kinetics-400-C and SSv2-C drivers
    (``vitta_tpu_torch.scripts.tta_swin_kinetics`` / ``tta_swin_ssv2``,
    Video Swin-B at its preset, 400 and 174 classes) on the card, one
    corruption of 2 synthetic videos each, from Swin-B's source statistics
    written by the port's ``compute_stats`` script over the same list; each
    must return a row for the corruption and the mean."""
    from vitta_tpu_torch.scripts import (compute_stats, tta_swin_kinetics,
                                         tta_swin_ssv2)
    with tempfile.TemporaryDirectory() as root:
        listing = os.path.join(root, "list.txt")
        with open(listing, "w") as f:
            f.write("vid_a 48 3\nvid_b 52 7\n")
        common = ["--video_source", "synthetic", "--val_vid_list", listing,
                  "--workers", "2", "--seed", str(seed)]
        t0 = time.perf_counter()
        paths = compute_stats.main(["--arch", "videoswintransformer",
                                    "--batch_size", "2", "--result_dir",
                                    os.path.join(root, "stats"), *common])
        stats_s = time.perf_counter() - t0
        lines = [f"compute_stats (Swin-B, 2 videos) {stats_s:.1f} s"]
        for name, driver, classes in (("kinetics", tta_swin_kinetics, 400),
                                      ("somethingv2", tta_swin_ssv2, 174)):
            t0 = time.perf_counter()
            results = driver.main(
                [*common, "--corruptions", "gauss", "--result_dir",
                 os.path.join(root, name), "--spatiotemp_mean_clean_file",
                 paths[0], "--spatiotemp_var_clean_file", paths[1]])
            seconds = time.perf_counter() - t0
            if set(results) != {"gauss", "mean"}:
                raise AssertionError(f"driver {name}: rows {results}")
            lines.append(f"{name} ({classes} classes): rows {results} in "
                         f"{seconds:.1f} s")
    print(f"zoo drivers on {card}: " + "; ".join(lines), flush=True)


# ---------------------------------------------------------------------------
# Phases 46-50: stream parallelism, the trainer, the entry
# ---------------------------------------------------------------------------
PARALLEL_STREAMS = 2    # phase 46: processes sharing the card
PAR_SWEEP_VIDEOS = 4    # phase 47: videos of each corruption (T 4, 64 x 64)
PAR_SWEEP_EVERY = 2     # its checkpoint cadence; the kill after the first
PAR_EVAL_VIDEOS = 5     # phase 48: batches of 2 and a remainder of 1
PAR_CLASSES = 8         # phases 47-48: few classes, so that top-5 can miss
# phase 48: the rank of each eval video's label among the source model's
# class scores (0 its first choice).  Top-1 reads 40 and top-5 80; a rank's
# share left out, one half evaluated twice or the remainder batch dropped
# each changes one of them (module docstring, phase 48)
PAR_EVAL_LABEL_RANKS = (0, 3, 6, 0, 1)
TRAIN_FULL_STEPS = 3    # phase 49: TANet, 4 clips of 16 x 224², 101 classes
TRAIN_ULP_SEEDS = (1, 2)  # phase 49: the CPU's one-ulp spreads it reads
TRAIN_SPREAD_FACTOR = 4   # and how many of them the card may read
GROUP_TIMEOUT_S = 600   # every launch of a process group


def _stream_measures(rec):
    """ms/video (median over the timed videos, host clock at each step's
    start), videos/s of the timed window, the profiled step's device-busy
    ms and its share of that median, peak GiB."""
    w, n = rec["warmup"], len(rec["starts"])
    starts = np.asarray(rec["starts"][w:n])   # the timed ones, then the
    window = starts[-1] - starts[0]           # profiled one's start
    ms = float(np.median(np.diff(starts))) * 1e3
    return {"ms_per_video": ms, "videos_per_s": (n - 1 - w) / window,
            "busy_ms": rec["busy_ms"], "profiled_ms": rec["profiled_ms"],
            "busy_share": rec["busy_ms"] / ms if rec["busy_ms"] else None,
            "peak_gib": rec["peak_gib"]}


def phase_parallel_streams(card):
    """Phase 46: PARALLEL_STREAMS TANet float32 streams at the reference
    operating point (``tools/parallel_streams.py``: mean_var, 2 views x 16 x
    224², 101 classes, seeded weights, each stream its own seeded videos,
    1 warm-up video, 8 timed and 1 profiled)
    as processes of one ``torchrun --standalone`` group: first sharing the
    card (``run_parallel_streams``, gloo, ``streams_per_chip`` the group's
    size), then each stream alone on the card in its own process while the
    others wait.  Each stream's per-video losses and eval logits, its final
    parameters and EMA must be the ones it has alone, bit for bit (cuDNN's
    deterministic algorithms); each run's wrappers must count 32 TAM
    forward, 16 backward and 29 + 29 BatchNorm-statistics launches a video,
    the libraries the same float32 kernels (two TAM backward launches a
    call).  Prints ms/video a stream, videos/s overall, each process's busy
    share (the profiled step's device-busy ms over the stream's median
    ms/video) and peak memory, shared and alone, and the host's usable
    cores."""
    from vitta_tpu_torch.tools import parallel_streams
    torch.cuda.empty_cache()
    n = PARALLEL_STREAMS
    recs = {}
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(n), "-m",
             "vitta_tpu_torch.tools.parallel_streams", out], cwd=ROOT,
            capture_output=True, text=True, timeout=GROUP_TIMEOUT_S,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        if proc.returncode != 0:
            raise AssertionError(f"parallel streams: exit {proc.returncode}"
                                 f"\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        launch_s = time.perf_counter() - t0
        for i in range(n):
            for mode in ("paired", "alone"):
                recs[i, mode] = torch.load(
                    os.path.join(out, f"stream_{i}_{mode}.pt"),
                    weights_only=False)
    nv = parallel_streams.VIDEOS
    for (i, mode), rec in recs.items():
        chosen = rec["chosen"]
        want = {"tam_fwd": 32 * nv, "tam_bwd": 16 * nv,
                "bn_stats_fwd": chosen * nv, "bn_stats_bwd": chosen * nv}
        if rec["launches"] != want or chosen != 29:
            raise AssertionError(f"stream {i} {mode}: launches "
                                 f"{rec['launches']}, expected {want}")
        lib = rec["library"]
        got = {k: sum(c for name, c in lib.items() if name.startswith(pre)
                      and "reduce" not in name and "bf16" not in name)
               for k, pre in (("tam_fwd", "tam_fwd"),
                              ("bn_stats_fwd", "bn_stats_fwd_kernel"),
                              ("bn_stats_bwd", "bn_stats_bwd_kernel"))}
        tam_bwd = sum(c for name, c in lib.items()
                      if name.startswith("tam_bwd"))
        if got != {k: want[k] for k in got} or tam_bwd != 2 * want["tam_bwd"]:
            raise AssertionError(f"stream {i} {mode}: the libraries' "
                                 f"launches {lib}")
    for i in range(n):
        a, b = recs[i, "paired"], recs[i, "alone"]
        if a["losses"] != b["losses"] or a["top1"] != b["top1"]:
            raise AssertionError(f"stream {i}: losses shared {a['losses']} "
                                 f"!= alone {b['losses']}")
        logit_err = max(float((x - y).abs().max())
                        for x, y in zip(a["logits"], b["logits"]))
        param_err = max(float((a["params"][k] - b["params"][k]).abs().max())
                        for k in b["params"])
        ema_err = max(float((x - y).abs().max()) for k in b["ema"]
                      for x, y in zip(a["ema"][k], b["ema"][k]))
        if len(a["logits"]) != nv or max(logit_err, param_err, ema_err):
            raise AssertionError(f"stream {i} shared against alone: logits "
                                 f"{logit_err:.3e}, parameters "
                                 f"{param_err:.3e}, EMA {ema_err:.3e}")
    m = {key: _stream_measures(rec) for key, rec in recs.items()}
    shared = sum(m[i, "paired"]["videos_per_s"] for i in range(n))
    alone = statistics.mean(m[i, "alone"]["videos_per_s"] for i in range(n))
    cores = recs[0, "paired"]["cores"]
    for (i, mode), r in sorted(m.items()):
        print(f"parallel streams, stream {i} {'shared' if mode == 'paired' else 'alone'}: "
              f"{r['ms_per_video']:.3f} ms/video (median of "
              f"{nv - 1 - parallel_streams.WARMUP}), {r['videos_per_s']:.3f} "
              f"videos/s, device busy {fmt(r['busy_ms'])} ms a step (the "
              f"profiled one took {fmt(r['profiled_ms'])} ms; busy share "
              f"{fmt(r['busy_share'])}), "
              f"peak memory {fmt(r['peak_gib'])} GiB; on {card}", flush=True)
    summary = {
        "streams": n, "videos": nv, "cores": cores,
        "ms_per_video": {f"{i} {mode}": m[i, mode]["ms_per_video"]
                         for i, mode in m},
        "videos_per_s_shared": shared, "videos_per_s_alone": alone,
        "throughput_ratio": shared / alone,
        "busy_share": {f"{i} {mode}": m[i, mode]["busy_share"]
                       for i, mode in m},
        "peak_gib": {f"{i} {mode}": m[i, mode]["peak_gib"] for i, mode in m},
        "launch_s": launch_s}
    print(f"parallel streams ({n} processes on one card, TANet float32, "
          f"{cores} usable cores a process): shared and alone bit-equal "
          f"(losses, logits, parameters, EMA), launches 32 / 16 / 29 / 29 a "
          f"video in every process; {shared:.3f} videos/s shared against "
          f"{alone:.3f} alone ({shared / alone:.3f}x); the group's launch "
          f"{launch_s:.1f} s; on {card}", flush=True)
    return summary


def _par_sweep_cfg(result_dir, resume):
    from vitta_tpu_torch.cli.opts import get_opts
    argv = ["--clip_length", "4", "--input_size", "64", "--scale_size", "72",
            "--result_dir", result_dir, "--video_source", "synthetic",
            "--stat_reg", "BNS", "--n_parallel_streams", "2",
            "--streams_per_chip", "2", "--stream_ckpt_every",
            str(PAR_SWEEP_EVERY), "--verbose", "false"]
    cfg = get_opts(argv + (["--resume"] if resume else []))[1]
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 num_classes=PAR_CLASSES))


def _par_records(n, labels=None):
    from vitta_tpu_torch.data.records import VideoRecord
    labels = labels or [i % PAR_CLASSES for i in range(n)]
    return [VideoRecord(f"par_{i}", 40 + 3 * i, labels[i]) for i in range(n)]


def _par_eval_set(labels=None):
    """Phase 48's eval videos (the synthetic source), and the source
    model on the card."""
    from vitta_tpu_torch.cli.main_eval import load_variables
    from vitta_tpu_torch.data.dataset import TANetVideoDataset
    from vitta_tpu_torch.data.video_reader import SyntheticVideoSource
    from vitta_tpu_torch.models import get_model
    cfg = _par_sweep_cfg("", False)
    model = get_model(cfg)
    model.load_state_dict(load_variables(cfg, seed=cfg.runtime.seed))
    ds = TANetVideoDataset(cfg, SyntheticVideoSource(),
                           _par_records(PAR_EVAL_VIDEOS, labels),
                           dataset_type="eval")
    return cfg, model, ds


def _eval_reference(cfg, model, ds):
    """Each eval video's mean logits on the card, and top-1 / top-5 as
    the baselines average them over batches of 2 (plain PyTorch:
    ``topk_accuracy`` a batch, weighted by its videos)."""
    from vitta_tpu_torch.baselines.common import (batched_eval_iter,
                                                  eval_views_of)
    from vitta_tpu_torch.ops.losses import topk_accuracy
    from vitta_tpu_torch.utils.meters import AverageMeter
    model = model.to("cuda")
    e = eval_views_of(cfg)
    means, top1, top5 = [], AverageMeter(), AverageMeter()
    for clips, labels in batched_eval_iter(ds, 2):
        with torch.no_grad():
            logits = model(torch.as_tensor(clips).cuda(), None, train=False)
        mean = logits.reshape(len(labels), e, -1).mean(dim=1)
        t1, t5 = topk_accuracy(mean, torch.as_tensor(labels).cuda())
        top1.update(float(t1), n=len(labels))
        top5.update(float(t5), n=len(labels))
        means.extend(mean.cpu())
    return means, (top1.avg, top5.avg)


def _group_worker(rank, world, store, phase, root, out):
    """A process of phases 47-48 (spawned): the parallel sweep over two
    corruptions on this rank's stream device.  ``phase`` "plain":
    ``sharded_validate``, the sweep through under ``root/plain``, then the
    sweep under ``root/cut`` until its first checkpoint commits, where the
    group exits (3) together; "resume": the sweep under ``root/cut`` with
    ``--resume``.  Every step's losses and the rows go to
    ``out.<plain|resume>.<rank>.json``."""
    import torch.distributed as dist

    from vitta_tpu_torch.adapt import stream_ckpt
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.cli.drivers import run_parallel_sweep
    from vitta_tpu_torch.parallel.data_eval import sharded_validate
    from vitta_tpu_torch.parallel.mesh import (coordination_barrier,
                                               initialize_distributed)

    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(num_processes=world, process_id=rank,
                           init_method=f"file://{store}",
                           timeout_s=GROUP_TIMEOUT_S)
    steps = []
    step = VittaEngine.adapt_eval_step

    def recorded(self, *a, **k):
        state, m = step(self, *a, **k)
        steps.append([float(m.loss_reg), float(m.loss_consis),
                      float(m.loss_ce), float(m.top1)])
        return state, m

    VittaEngine.adapt_eval_step = recorded

    def sweep(where, resume):
        t0 = time.perf_counter()
        rows = run_parallel_sweep(
            _par_sweep_cfg(os.path.join(root, where), resume),
            ["gauss", "contrast"], source_kind="synthetic",
            records=_par_records(PAR_SWEEP_VIDEOS))
        return rows, time.perf_counter() - t0

    try:
        record = {}
        if phase == "plain":
            with open(os.path.join(root, "labels.json")) as f:
                cfg, model, ds = _par_eval_set(json.load(f))
            t0 = time.perf_counter()
            record["validate"] = sharded_validate(model, ds, cfg,
                                                  batch_size=2)
            record["validate_s"] = time.perf_counter() - t0
        record["rows"], record["sweep_s"] = sweep(
            "plain" if phase == "plain" else "cut", phase == "resume")
        record["steps"] = list(steps)
        with open(f"{out}.{phase}.{rank}.json", "w") as f:
            json.dump(record, f)
        if phase == "plain":
            real_save = stream_ckpt.StreamCheckpointer.save

            def save_then_die(self, *a, **k):
                real_save(self, *a, **k)
                coordination_barrier("preempted")
                os._exit(3)

            stream_ckpt.StreamCheckpointer.save = save_then_die
            sweep("cut", False)
            raise AssertionError("the checkpoint hook never fired")
    finally:
        dist.destroy_process_group()


def phase_parallel_sweep(card):
    """Phases 47-48: ``run_parallel_sweep`` over two corruptions of
    PAR_SWEEP_VIDEOS synthetic videos as 2 spawned processes on the card
    (``streams_per_chip`` 2, TANet at T 4, 64 x 64, PAR_CLASSES classes,
    BNS, the CLI's seeded weights, ``--stream_ckpt_every 2``, cuDNN
    deterministic): one run through, one killed right after its first
    checkpoint commits (its group directory then holds each rank's state
    file under ``step_2/``) and resumed with ``--resume``; the resumed rows
    must be the uninterrupted run's on both ranks, and every step from the
    resume point on its losses and top-1.  Before the sweep the
    uninterrupted run's processes run ``sharded_validate`` over
    PAR_EVAL_VIDEOS eval videos in batches of 2 (the last a remainder of
    one, rank 0's alone): top-1 and top-5 equal, on both ranks, to the
    source-only baseline's top-1 and to a plain evaluation's top-1 and
    top-5 on the card.  Each eval video's label is the class that the
    source model ranks PAR_EVAL_LABEL_RANKS there, so that the reference
    reads strictly between 0 and 100 on both counts and a lost share, a
    half evaluated twice or a dropped remainder changes the reading.  One
    group runs the validation, the sweep through and the sweep that is
    killed, one after the other; a second group resumes."""
    from vitta_tpu_torch.baselines import setup_baseline
    from vitta_tpu_torch.cli.main_eval import load_variables
    from vitta_tpu_torch.models import get_model
    from vitta_tpu_torch.parallel.mesh import SpawnedGroup

    torch.cuda.empty_cache()
    # the eval videos' labels from the source model's ranking on the card
    cfg, model, ds = _par_eval_set()
    means, _ = _eval_reference(cfg, model, ds)
    labels = [int(torch.argsort(m, descending=True)[k])
              for m, k in zip(means, PAR_EVAL_LABEL_RANKS)]
    cfg, model, ds = _par_eval_set(labels)
    _means, want = _eval_reference(cfg, model, ds)
    ref = setup_baseline("source", get_model(cfg), cfg,
                         load_variables(cfg, seed=cfg.runtime.seed),
                         device="cuda").run(ds, batch_size=2)
    del model
    if ref != want[0] or not all(0 < v < 100 for v in want):
        raise AssertionError(f"phase 48's reference: top-1 / top-5 {want}, "
                             f"the source baseline's top-1 {ref}")
    with tempfile.TemporaryDirectory() as root:
        with open(os.path.join(root, "labels.json"), "w") as f:
            json.dump(labels, f)
        out = os.path.join(root, "sweep")
        t0 = time.perf_counter()
        SpawnedGroup(_group_worker, 2, (os.path.join(root, "store_plain"),
                                        "plain", root, out)).join(
            GROUP_TIMEOUT_S, expect=3, what="parallel sweep, then killed")
        first_s = time.perf_counter() - t0
        (ckpt,) = [d for d in os.listdir(os.path.join(root, "cut"))
                   if d.startswith("stream_ckpt_group_")]
        ckpt = os.path.join(root, "cut", ckpt)
        files = sorted(os.listdir(os.path.join(ckpt,
                                               f"step_{PAR_SWEEP_EVERY}")))
        if files != ["rank_0.pt", "rank_1.pt"]:
            raise AssertionError(f"the killed group's checkpoint: {files}")
        t0 = time.perf_counter()
        SpawnedGroup(_group_worker, 2, (os.path.join(root, "store_resume"),
                                        "resume", root, out)).join(
            GROUP_TIMEOUT_S, what="parallel sweep, resumed")
        resume_s = time.perf_counter() - t0
        got = {}
        for phase in ("plain", "resume"):
            for r in range(2):
                with open(f"{out}.{phase}.{r}.json") as f:
                    got[phase, r] = json.load(f)
    for r in range(2):
        if got["resume", r]["rows"] != got["plain", 0]["rows"] or \
                got["plain", r]["rows"] != got["plain", 0]["rows"]:
            raise AssertionError(f"rank {r}: rows {got['resume', r]['rows']}"
                                 f" against {got['plain', 0]['rows']}")
        if got["resume", r]["steps"] != \
                got["plain", r]["steps"][PAR_SWEEP_EVERY:]:
            raise AssertionError(f"rank {r}: the resumed steps differ")
    print(f"parallel sweep (2 processes, one card, {PAR_CLASSES} classes): "
          f"rows {got['plain', 0]['rows']}; killed after the checkpoint at "
          f"video {PAR_SWEEP_EVERY} and resumed: rows and the "
          f"{PAR_SWEEP_VIDEOS - PAR_SWEEP_EVERY} resumed steps' losses equal "
          f"on both ranks; validation, sweep and killed sweep {first_s:.1f} s"
          f" in one group (sweep {got['plain', 0]['sweep_s']:.1f} s in a "
          f"process), resumed {resume_s:.1f} s; on {card}", flush=True)
    # phase 48: sharded_validate against the references on the card
    ranks = [tuple(got["plain", r]["validate"]) for r in range(2)]
    if ranks[0] != ranks[1] or ranks[0] != want:
        raise AssertionError(f"sharded_validate {ranks} against the plain "
                             f"evaluation's top-1 / top-5 {want}")
    print(f"sharded_validate (2 processes, {PAR_EVAL_VIDEOS} videos in "
          f"batches of 2, labels ranked {PAR_EVAL_LABEL_RANKS} by the source "
          f"model): top-1 / top-5 {ranks[0]} on both ranks, the plain "
          f"evaluation's {want}, the source baseline's top-1 {ref}; "
          f"{got['plain', 0]['validate_s']:.2f} s; on {card}", flush=True)
    return {"rows": got["plain", 0]["rows"], "validate": ranks[0],
            "resume_s": resume_s}


def _trainer_snapshots(trainer, state, batches):
    """Each step's starting point (state dict and momentum by name) of
    ``trainer`` over ``batches``, the last the end; with the metrics."""
    snaps, metrics = [], []
    for x, y in batches:
        snaps.append(({k: v.detach().clone() for k, v in
                       trainer.model.state_dict().items()},
                      {k: state.optimizer.state[p]["momentum_buffer"].clone()
                       for k, p in state.params.items()
                       if p in state.optimizer.state}))
        state, m = trainer.train_step(state, x, y)
        metrics.append([float(v) for v in m])
    snaps.append(({k: v.detach().clone() for k, v in
                   trainer.model.state_dict().items()},
                  {k: state.optimizer.state[p]["momentum_buffer"].clone()
                   for k, p in state.params.items()}))
    return snaps, metrics


def _trainer_step_from(trainer, start, mom, k, x, y):
    """``trainer``'s step ``k`` from the state dict ``start`` and the
    momentum buffers ``mom`` (by name; none before the first step): the
    state dict and momentum after it, on the CPU, and the metrics."""
    state = trainer.init_state(start)
    for n_, p in state.params.items():
        if n_ in mom:
            state.optimizer.state[p]["momentum_buffer"] = \
                mom[n_].to(trainer.device, copy=True)
    state, m = trainer.train_step(dataclasses.replace(state, step=k), x, y)
    return ({n_: v.to("cpu", copy=True)
             for n_, v in trainer.model.state_dict().items()},
            {n_: state.optimizer.state[p]["momentum_buffer"].to(
                "cpu", copy=True) for n_, p in state.params.items()},
            [float(v) for v in m])


def _update_gap(run, run_start, want, want_mom, start):
    """(update, momentum): how far ``run`` (a ``_trainer_step_from``
    result from ``run_start``) is from the step that went from ``start`` to
    the state dict ``want`` and momentum ``want_mom``, each over all
    parameters as one vector, relative to the norm of the wanted one."""
    got, got_mom, _m = run
    names = list(want_mom)
    upd = [torch.cat([(sd[n_] - s0[n_]).ravel() for n_ in names])
           for sd, s0 in ((got, run_start), (want, start))]
    mom = [torch.cat([m_[n_].ravel() for n_ in names])
           for m_ in (got_mom, want_mom)]
    return tuple(float((a - b).norm() / b.norm()) for a, b in (upd, mom))


def phase_trainer(card, seed=SEED):
    """Phase 49: the trainer (``adapt/train.py``).  Card against CPU at T 2,
    64 x 64, 4 clips, 5 classes, dropout 0, lr 1e-3 dropping x0.1 after
    every step, clipping at 0.5: 3 steps, each from the CPU's state before
    it: the loss rtol 2e-3, top-1 equal, running statistics within 1e-3 of
    each layer's largest.  The batch-statistics step of a random-weight
    TANet is ill-conditioned (tests/test_torch_train.py): one float32 ulp of
    the weights moves the CPU's own whole update by 1-7% of its norm.  So
    each step's whole update and momentum are held within
    TRAIN_SPREAD_FACTOR times the largest such spread of TRAIN_ULP_SEEDS
    on the CPU, and never more than 10%, as tests/test_torch_train.py
    holds the port against vitta_tpu (cuDNN sums every convolution in
    another order, which moves every activation and not only the weights);
    the CPU's step without weight decay (a planted fault) must read beyond
    that bound at one step at least, or the check could not fail.
    Then full size: TANet at 101 classes, 4 clips of 16 x 224²,
    TRAIN_FULL_STEPS steps and a profiled one: 16 TAM forward and 16
    backward launches a step, ms/step, busy, peak memory; a checkpoint
    round trip bit-equal; the model's counts (``utils/analysis.py``)."""
    from vitta_tpu_torch.adapt.train import (Trainer, restore_checkpoint,
                                             save_checkpoint)
    from vitta_tpu_torch.models.tanet import TANet
    from vitta_tpu_torch.ops import cuda_tam
    from vitta_tpu_torch.utils.analysis import model_analysis

    sched = dict(lr=1e-3, lr_steps=(1, 2), steps_per_epoch=1,
                 clip_gradient=0.5)
    torch.manual_seed(seed)
    sd = TANet(5, clip_length=2, dropout=0.0).state_dict()
    rng = np.random.default_rng(seed)
    batches = [(rng.normal(size=(4, 2, 64, 64, 3)).astype(np.float32),
                (np.arange(4) + i) % 5) for i in range(3)]

    def trainer(device, **kw):
        return Trainer(TANet(5, clip_length=2, dropout=0.0), device=device,
                       **sched, **kw)

    cpu = trainer("cpu")
    snaps, metrics = _trainer_snapshots(cpu, cpu.init_state(sd), batches)
    gpu, no_wd = trainer("cuda"), trainer("cpu", weight_decay=0.0)
    rows, caught = [], False
    for k, (x, y) in enumerate(batches):
        start, mom = snaps[k]
        want, want_mom = snaps[k + 1]
        run = _trainer_step_from(gpu, start, mom, k, x, y)
        got, _got_mom, (loss, top1, _top5) = run
        stat = max(float((got[n_] - w).abs().max() / w.abs().max())
                   for n_, w in want.items()
                   if n_.endswith(("running_mean", "running_var")))
        lerr = abs(loss - metrics[k][0]) / abs(metrics[k][0])
        gap = _update_gap(run, start, want, want_mom, start)
        spread = [0.0, 0.0]
        for s_ in TRAIN_ULP_SEEDS:
            away = _one_ulp_away(start, s_)
            ulp = _update_gap(_trainer_step_from(cpu, away, mom, k, x, y),
                              away, want, want_mom, start)
            spread = [max(a, b) for a, b in zip(spread, ulp)]
        bound = [min(0.1, TRAIN_SPREAD_FACTOR * v) for v in spread]
        fault = _update_gap(_trainer_step_from(no_wd, start, mom, k, x, y),
                            start, want, want_mom, start)
        caught |= any(f > b for f, b in zip(fault, bound))
        rows.append((lerr, stat, gap, spread, fault))
        if (lerr > 2e-3 or top1 != metrics[k][1] or stat > 1e-3
                or any(g > b for g, b in zip(gap, bound))):
            raise AssertionError(f"trainer card vs cpu step {k}: loss "
                                 f"{loss} / {metrics[k][0]}, top-1 {top1} / "
                                 f"{metrics[k][1]}, statistics {stat:.2e}, "
                                 f"update / momentum {gap} against "
                                 f"{bound}")
    if not caught:
        raise AssertionError("trainer card vs cpu: the step without weight "
                             "decay reads within the bounds at every step "
                             f"({[r[4] for r in rows]})")
    print("trainer small slice card vs cpu (T 2, 64 x 64, 4 clips, each step "
          "from the CPU's state; update / momentum gaps of their norms, the "
          "CPU's largest one-ulp spread, the CPU without weight decay): "
          + "; ".join(f"step {k} loss {r[0]:.2e} statistics {r[1]:.2e} "
                      f"card {r[2][0]:.4f} / {r[2][1]:.4f}, one ulp "
                      f"{r[3][0]:.4f} / {r[3][1]:.4f}, no weight decay "
                      f"{r[4][0]:.4f} / {r[4][1]:.4f}"
                      for k, r in enumerate(rows)) + f"; on {card}",
          flush=True)

    # full size
    del cpu, gpu, no_wd
    torch.cuda.empty_cache()
    torch.manual_seed(seed)
    model = TANet(101, clip_length=16)
    info = model_analysis(model)
    trainer = Trainer(model, device="cuda", **sched)
    state = trainer.init_state()
    clips = [(rng.normal(size=(4, 16, 224, 224, 3)).astype(np.float32),
              (np.arange(4) + i) % 101) for i in range(TRAIN_FULL_STEPS + 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_tam.counters.reset()
    ms = []
    for x, y in clips[:TRAIN_FULL_STEPS]:
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, x, y)
        float(m[0])
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = (cuda_tam.counters.fwd, cuda_tam.counters.bwd)
    if counts != (16 * TRAIN_FULL_STEPS, 16 * TRAIN_FULL_STEPS):
        raise AssertionError(f"trainer: TAM launches {counts} over "
                             f"{TRAIN_FULL_STEPS} steps, expected 16 + 16 a "
                             "step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    it = iter(clips[TRAIN_FULL_STEPS:])

    def one():
        nonlocal state
        x, y = next(it)
        state, m = trainer.train_step(state, x, y)
        float(m[0])

    host_ms, busy, _classes, largest = _profile_train(one)
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "train.pt")
        save_checkpoint(path, state)
        want = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        want_mom = {k: state.optimizer.state[p]["momentum_buffer"].clone()
                    for k, p in state.params.items()}
        other = Trainer(TANet(101, clip_length=16), device="cuda", **sched)
        got = restore_checkpoint(path, target=other.init_state())
    same = (got.step == state.step and all(
        torch.equal(v, want[k]) for k, v in other.model.state_dict().items())
        and all(torch.equal(got.optimizer.state[p]["momentum_buffer"],
                            want_mom[k]) for k, p in got.params.items()))
    if not same:
        raise AssertionError("trainer checkpoint: the restored state differs")
    summary = {"ms_per_step": statistics.median(ms[1:]), "ms": ms,
               "host_ms": host_ms, "busy_ms": busy, "peak_gib": peak,
               "analysis": info}
    print(f"trainer full size (TANet, 101 classes, 4 clips of 16 x 224², "
          f"SGD, clipping at 0.5, batch statistics): {TRAIN_FULL_STEPS} steps "
          f"{', '.join(f'{v:.1f}' for v in ms)} ms (the first warms up), "
          f"TAM launches 16 + 16 a step, profiled step host {host_ms:.3f} ms "
          f"busy {fmt(busy)} ms, largest "
          + "; ".join(f"{k[:40]} {t:.2f} ms x{c}" for k, t, c in largest[:3])
          + f", peak memory {peak:.3f} GiB; checkpoint round trip "
          f"bit-equal; model_analysis {info}; on {card}", flush=True)
    return summary


def _profile_train(step):
    """(host ms, busy ms, classes, largest) of one trainer step under the
    profiler, as ``_profile_step`` reads an adapt step."""
    from torch.profiler import ProfilerActivity, profile
    from vitta_tpu_torch.tools.tanet_breakdown import kernel_classes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) or None
    return host_ms, busy, kernel_classes(rows), rows


def phase_entry(card):
    """Phase 50: ``entry.entry()`` (TANet's forward at T 8, 112², 101
    classes, on the card) and ``entry.dryrun_multichip(2)``: one
    stream-parallel adapt+eval step over 2 spawned processes on the card,
    2 finite losses."""
    from vitta_tpu_torch import entry
    fn, args = entry.entry()
    out = fn(*args)
    if tuple(out.shape) != (2, 101) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"entry: logits {tuple(out.shape)}")
    del fn, args, out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    losses = entry.dryrun_multichip(2)
    print(f"entry: forward (2, 101) finite; dryrun_multichip(2) losses "
          f"{losses} in {time.perf_counter() - t0:.1f} s; on {card}",
          flush=True)


# ---------------------------------------------------------------------------
# Video Swin's layout variants (phases 51-53): VITTA_WINDOW_RESIDENT and
# VITTA_PATCHIFY_V2, each read when a model is built

LAYOUT_FLAGS = ("VITTA_WINDOW_RESIDENT", "VITTA_PATCHIFY_V2")
# phase 51: (route, the flags on) of each small slice, at float32 and
# bfloat16; the window layout on every route, the product patch embedding
# also alone (the window layout off: its counter must read 0)
LAYOUT_SMALL = (("packed", ("VITTA_PATCHIFY_V2",)),
                ("packed", ("VITTA_WINDOW_RESIDENT",)),
                ("heads", ("VITTA_WINDOW_RESIDENT",)),
                ("proj", ("VITTA_WINDOW_RESIDENT", "VITTA_PATCHIFY_V2")),
                ("ln_proj", ("VITTA_WINDOW_RESIDENT",)))
# phase 52: the forms of Swin-B compared in turns on the packed route, by
# the flags each turns on
LAYOUT_FORMS = {"spatial": (), "window-resident": ("VITTA_WINDOW_RESIDENT",),
                "product patch embedding": ("VITTA_PATCHIFY_V2",)}
LAYOUT_VIDEOS = 8     # timed videos a turn, after one warm-up video
LAYOUT_ROUNDS = 3     # phase 52's rounds of the forms in turns (phase 53: 1)
# the kernels that only move data, by a part of their names: the spatial
# form's rolls and window copies, the window layout's gathers, casts and
# concatenations
MOVEMENT_KERNELS = ("roll", "cat", "copy", "index")


class layout_flags:
    """Within ``with``: the flags in ``on`` set to 1 and the other layout
    flags to 0, for what is built there to read; restored after."""

    def __init__(self, *on):
        self.on = set(on)

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in LAYOUT_FLAGS}
        for k in LAYOUT_FLAGS:
            os.environ[k] = "1" if k in self.on else "0"

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _err(v) -> str:
    return "-" if v is None else f"{v:.2e}"


def _short(flags):
    return "+".join(f[len("VITTA_"):].lower() for f in flags) or "default"


def _model_took(model):
    """{flag: whether the model took it} of the flags a model reads."""
    backbone = model.backbone
    return {"VITTA_WINDOW_RESIDENT": all(layer.window_resident
                                         for layer in backbone.layers),
            "VITTA_PATCHIFY_V2": backbone.patch_embed.patchify_v2}


def _check_layout_taken(what, took, flags):
    """Raise unless each flag of ``took`` ({flag: taken}) was taken as it
    is set: no form passes untaken."""
    for k, v in took.items():
        if v != (k in flags):
            raise AssertionError(f"{what}: {k} is "
                                 f"{'on' if k in flags else 'off'}, taken "
                                 f"{'on' if v else 'off'}")


def phase_layout_small(seed=SEED):
    """Phase 51: the small Swin of phase 26 (embed 128, depths (2, 1), heads
    (4, 8), window (2, 3, 3), 4 x 48²: both stages shift H and W) under each
    of LAYOUT_SMALL, at float32 (two tta_online steps card against CPU,
    phase 10's bounds) and bfloat16 (phase 26's); the window layout's
    counter above 0 where its flag is on and 0 where it is off, every other
    flag taken as set."""
    from vitta_tpu_torch.models import swin
    cfg = _swin_cfg(t=4, hw=48, **BF16_SWIN_SMALL)
    for dtype in ("float32", "bfloat16"):
        for route, flags in LAYOUT_SMALL:
            what = (f"swin layout small slice ({dtype}, {route}, "
                    f"{_short(flags)})")
            with layout_flags(*flags):
                _check_layout_taken(what, _model_took(_synthetic_swin(
                    cfg, dtype, attn_route=route)), flags)
                if dtype == "float32":
                    phase_swin_adapt_small(cfg, seed, 4, 48, attn_route=route,
                                           what=what)
                else:
                    phase_bf16_swin_small(seed, route=route, what=what)
                stages = swin.counters.window_resident_stages
            if (stages > 0) != ("VITTA_WINDOW_RESIDENT" in flags):
                raise AssertionError(f"{what}: {stages} stage passes in "
                                     "window layout")
            print(f"{what}: {stages} stage passes in window layout",
                  flush=True)


def _movement(rows):
    """(launches, device ms, the four most launched by name) of the
    data-movement kernels among the profiler's ``rows``."""
    moved = sorted(((n, ms, k) for k, ms, n in rows
                    if any(p in k.lower() for p in MOVEMENT_KERNELS)),
                   reverse=True)
    return (sum(n for n, _ms, _k in moved), sum(ms for _n, ms, _k in moved),
            [(k[:70], n) for n, _ms, k in moved[:4]])


def phase_layout_turns(cfg, sd, stats, seed, card, dtype, forms,
                       rounds=LAYOUT_ROUNDS, what="swin-B", tf32=False):
    """Phases 52-53: one engine of the Swin of ``cfg`` at ``dtype`` per
    form in ``forms`` ({name: (route, flags)}), each built once under its
    flags; ``rounds`` turns of the forms (in order, then reversed in the
    next round), each turn a fresh stream of 1 warm-up and LAYOUT_VIDEOS
    timed videos (``adapt_eval_step``, drop-path and head dropout on, each
    video's generator seeded as ``tta_stream`` seeds it; host clock,
    synchronised).  In the first round each video's losses and, untimed,
    its eval logits after the step; each form held to the first's:
    window-resident at float32 to vitta_tpu's own bound for the window
    layout (rtol / atol 2e-5, tests/test_swin_window_resident.py), the
    product patch embedding at float32 to phase 11's (losses rtol 1e-3 /
    atol 1e-5, logits rtol 2e-3 / atol 2e-4), every form at bfloat16 to
    phase 26's (reg and ce losses rtol 1e-3, consistency atol 2e-4, logits
    within 2e-2 of the largest).  ``tf32``: cuDNN's TF32 on throughout, as
    PyTorch has it by default (the Conv3d patch embedding in TF32; every
    other float32 product is the port's kernels' or cuBLAS's with TF32 off
    either way), and the forms held to the bfloat16 bounds: TF32 keeps 10
    bits of mantissa, bfloat16 7.
    Then one step each: the wrappers' launches and the stages in window
    layout, the step's peak memory above what the engines hold, and a
    profiled step: device busy, idle share, launches, the data-movement
    kernels' launches and ms.  Returns {form: summary}."""
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _layout_turns(cfg, sd, stats, seed, card, dtype, forms, rounds,
                             what, tf32)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _layout_turns(cfg, sd, stats, seed, card, dtype, forms, rounds, what,
                  tf32):
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.adapt.loops import video_seed
    from vitta_tpu_torch.models import swin
    t, hw = cfg.data.clip_length, cfg.data.input_size
    videos = [tuple(torch.from_numpy(a).cuda() for a in v) for v in
              _videos(np.random.default_rng(seed + 5), 1 + LAYOUT_VIDEOS, t,
                      hw)]
    engines = {}
    for form, (route, flags) in forms.items():
        with layout_flags(*flags):
            engines[form] = VittaEngine(
                _synthetic_swin(cfg, dtype, attn_route=route), cfg, sd, stats)
        _check_layout_taken(f"{what} {dtype} {form}",
                            _model_took(engines[form].model), flags)
    out = {f: {"ms": [], "losses": [], "logits": []} for f in forms}
    order = list(forms)
    for r in range(rounds):
        for form in (order if r % 2 == 0 else order[::-1]):
            eng, rec = engines[form], out[form]
            state = eng.init_state()
            for i, (views, clip, label) in enumerate(videos):
                eng.generator.manual_seed(video_seed(seed, i))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = eng.adapt_eval_step(state, views, clip, label)
                losses = [float(m.loss_reg), float(m.loss_consis),
                          float(m.loss_ce)]
                torch.cuda.synchronize()
                if i:
                    rec["ms"].append((time.perf_counter() - t0) * 1e3)
                if r == 0:
                    rec["losses"].append(losses)
                    rec["logits"].append(eng.eval_logits(clip).cpu())
    base = order[0]
    # the bfloat16 bounds at bfloat16 and under cuDNN's TF32
    loose = dtype != "float32" or tf32
    for form in order[1:]:
        exact = "product" not in form
        for i, (a, b) in enumerate(zip(out[form]["losses"],
                                       out[base]["losses"])):
            for name, x, y in zip(("reg", "consis", "ce"), a, b):
                if not loose:
                    ok = (abs(x - y) <= 2e-5 + 2e-5 * abs(y) if exact
                          else abs(x - y) <= 1e-5 + 1e-3 * abs(y))
                else:
                    ok = (abs(x - y) <= 2e-4 if name == "consis"
                          else abs(x - y) <= 1e-3 * abs(y))
                if not ok:
                    raise AssertionError(f"{what} {dtype} {form} video {i} "
                                         f"loss_{name}: {x} against {y}")
        for i, (a, b) in enumerate(zip(out[form]["logits"],
                                       out[base]["logits"])):
            if not loose:
                rtol, atol = (2e-5, 2e-5) if exact else (2e-3, 2e-4)
                err = check_close(f"{what} {form} eval logits {i}", a, b,
                                  rtol, atol)
            else:
                err = check_scaled(f"{what} {form} eval logits {i}", a, b,
                                   2e-2)
            out[form]["logit_err"] = max(err, out[form].get("logit_err", 0))
        out[form]["loss_err"] = max(
            abs(x - y) for a, b in zip(out[form]["losses"],
                                       out[base]["losses"])
            for x, y in zip(a, b))
    views, clip, label = videos[-1]
    for form in order:
        eng, rec = engines[form], out[form]
        box = [eng.init_state()]

        def step():
            box[0], _m = eng.adapt_eval_step(box[0], views, clip, label)
        step()
        torch.cuda.synchronize()
        _reset_swin_counts()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        rec["peak_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
        counts = _swin_counts()
        counts["window_resident_stages"] = (
            swin.counters.window_resident_stages)
        rec["launches"] = {k: n for k, n in counts.items() if n}
        host, busy, rows = device_breakdown(step, top=None)
        moves, move_ms, most = _movement(rows)
        rec.update(host_ms=host, busy_ms=busy if busy > 0 else None,
                   idle_share=max(0.0, 1 - busy / host) if busy > 0 else None,
                   kernel_launches=sum(n for _k, _ms, n in rows),
                   movement_launches=moves, movement_ms=move_ms,
                   movement_most=most,
                   median_ms=statistics.median(rec["ms"]),
                   min_ms=min(rec["ms"]), max_ms=max(rec["ms"]))
        wr = "VITTA_WINDOW_RESIDENT" in forms[form][1]
        if (counts["window_resident_stages"] > 0) != wr:
            raise AssertionError(f"{what} {dtype} {form}: "
                                 f"{counts['window_resident_stages']} stage "
                                 "passes in window layout")
        if counts["contiguity_copies"]:
            raise AssertionError(f"{what} {dtype} {form}: contiguity copies")
    # the same kernels a step as the default form
    exp = dict(out[base]["launches"])
    for form in order[1:]:
        got = dict(out[form]["launches"])
        got.pop("window_resident_stages", None)
        if got != exp:
            raise AssertionError(f"{what} {dtype} {form}: launches {got}, "
                                 f"expected {exp}")
    for form in order:
        r = out[form]
        print(f"{what} {dtype} layout form {form!r} ({forms[form][0]}"
              f"{', cuDNN TF32 on' if tf32 else ''}), in "
              f"turns ({rounds} rounds of {LAYOUT_VIDEOS} videos after 1 "
              f"warm-up): median {r['median_ms']:.3f} ms/video (min "
              f"{r['min_ms']:.3f}, max {r['max_ms']:.3f}); profiled step: "
              f"host {r['host_ms']:.3f} ms, device busy {fmt(r['busy_ms'])} "
              f"ms, idle share {fmt(r['idle_share'])}, {r['kernel_launches']} "
              f"kernel launches, of which data movement "
              f"{r['movement_launches']} taking {r['movement_ms']:.3f} ms "
              f"(most launched: {r['movement_most']}); "
              f"step peak {r['peak_gib']:.3f} GiB above the engines' memory; "
              f"launches a step by wrapper {r['launches']}; against "
              f"{base!r}: losses max abs {_err(r.get('loss_err'))}, eval "
              f"logits max abs {_err(r.get('logit_err'))}; on {card}",
              flush=True)
    del engines
    torch.cuda.empty_cache()
    return {f: {k: v for k, v in r.items()
                if k not in ("losses", "logits", "ms")}
            for f, r in out.items()}


def phase_layout_forms(card, swin_b=None, swin_t=None):
    """Phases 52-53: Swin-B's forms at float32 and bfloat16 in turns, its
    spatial form and product patch embedding at float32 again with cuDNN's
    TF32 on (PyTorch's default), then Swin-T's spatial and window-resident
    forms on the packed and heads routes.  ``swin_b`` and ``swin_t`` are (state dict, source statistics);
    where None, seeded weights and one batch's statistics made here, so
    that the phases run alone after the build:

        python3 -c "import torch, chip_smoke as c; ...; c.phase_layout_forms(c.card_line())"

    Returns {"<model> <dtype>[ <route>]": {form: summary}}."""
    from vitta_tpu_torch.adapt.precompute import compute_source_statistics
    out = {}
    for name, given in (("swin-B", swin_b), ("swin-T", swin_t)):
        cfg = _swin_cfg(**SWIN_MODELS["swin_b" if name == "swin-B"
                                      else "swin_t"])
        if given is None:
            sd = _swin_weights(cfg, SEED)
            given = sd, compute_source_statistics(
                _swin_model(cfg, sd), _normalized_batches(
                    np.random.default_rng(SEED), cfg, (2,), 16, 224))
        sd, stats = given
        if name == "swin-B":
            forms = {f: ("packed", flags)
                     for f, flags in LAYOUT_FORMS.items()}
            for dtype in ("float32", "bfloat16"):
                out[f"{name} {dtype}"] = phase_layout_turns(
                    cfg, sd, stats, SEED, card, dtype, forms)
            out[f"{name} float32, cuDNN TF32 on"] = phase_layout_turns(
                cfg, sd, stats, SEED, card, "float32",
                {f: forms[f] for f in ("spatial", "product patch embedding")},
                tf32=True)
            continue
        for route in ("packed", "heads"):
            out[f"{name} float32 {route}"] = phase_layout_turns(
                cfg, sd, stats, SEED, card, "float32",
                {f: (route, flags) for f, flags in LAYOUT_FORMS.items()
                 if f in ("spatial", "window-resident")},
                rounds=1, what=name)
    print("Swin layout forms in turns: " + json.dumps(out)
          + f"; on {card}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    from vitta_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phases 1-50 measure the default layout whatever the shell exports;
    # phases 51-53 set the flags themselves (layout_flags)
    for k in LAYOUT_FLAGS:
        os.environ[k] = "0"
    card = card_line()
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}); TF32 off for "
          "matmuls and convolutions: every comparison is float32 but those "
          "of phases 22-24, which are bfloat16's", flush=True)

    t0 = time.perf_counter()
    ptxas = start_ptxas_report(_build)
    built = _build.build_all()
    print(f"build: {', '.join(f'{k}.cu {v:.2f} s' for k, v in built.items())}"
          f" ({time.perf_counter() - t0:.2f} s in all) into "
          f"{os.path.relpath(_build.BUILD_DIR, ROOT)}", flush=True)
    wgmma_build_report(_build, ptxas)

    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"[{what}: {now - clock[0]:.1f} s]", flush=True)
        clock[0] = now

    dev = torch.device("cuda")
    tam_rows = phase_tam_kernels(dev)
    lap("phase 3, TAM kernels")
    swin_rows = phase_swin_kernels(dev)
    lap("phase 4, Swin kernels")
    proj_rows = phase_swin_proj_kernels(dev)
    lap("phase 12, projection-fused attention kernels")
    unfused_rows = phase_unfused_kernels(dev)
    lap("phase 15, MLP and per-(head, window) attention kernels")
    gemm_rates = phase_gemm_rates(dev)
    lap("phase 21, gemm_tiles' rates")
    bn_rows = phase_bn_stats_kernels(dev)
    lap("phase 18, BatchNorm-statistics kernels")
    bf16_rows = phase_bf16_kernels(dev)
    lap("phase 22, bfloat16 TAM and BatchNorm-statistics kernels")
    small_bn = phase_small_slice(SEED)
    if 0 in small_bn:
        raise AssertionError("small slice: the bn_stats kernels never ran")
    launches, tanet = phase_full_slice(SEED, N_VIDEOS, card)
    if tanet["chosen"] != 29:   # 19 BatchNorm2d in layer3 + 10 in layer4
        raise AssertionError(f"{tanet['chosen']} chosen layers, expected 29")
    lap("phases 5-6, TANet slices")
    for row in tam_rows + bn_rows:
        row["launches"] = launches[row["name"]]
    # the bfloat16 TANet: small slice card against CPU, the full stream,
    # then float32 against bfloat16 trajectories
    small_bf16 = phase_small_slice(SEED, what="small slice (bfloat16)",
                                   dtype="bfloat16")
    if 0 in small_bf16:
        raise AssertionError("small slice (bfloat16): the bn_stats kernels "
                             "never ran")
    bf16_launches, tanet_bf16 = phase_full_slice(SEED, BF16_VIDEOS, card,
                                                 dtype="bfloat16")
    for row in bf16_rows:
        row["launches"] = bf16_launches[row["name"][:-len("_bf16")]]
    lap("phase 23, TANet bfloat16 slices")
    gate = phase_bf16_trajectories(card, GATE_VIDEOS)
    lap("phase 24, float32 against bfloat16 trajectories")
    # the engine's other modes on TANet: small slices against the CPU, then
    # each at full size
    for what, kw in (
            ("BNS, running EMA", dict(tta=dict(stat_reg="BNS"))),
            ("BNS, raw batch statistics",
             dict(tta=dict(stat_reg="BNS", running_manner=False))),
            ("cossim, l1_loss",
             dict(tta=dict(stat_reg="cossim", stat_type=("temp",)))),
            ("Adam on the norm affine parameters",
             dict(optim=dict(lr=1e-3, update_only_bn_affine=True), rel=0.1)),
            ("tta_epoch_adapt", dict(epoch=True))):
        phase_small_slice(SEED, what=f"small slice ({what})", **kw)
    phase_swin_adapt_small(
        _swin_cfg(t=4, hw=24, embed_dim=8, depths=(1, 1, 2, 1),
                  num_heads=(1, 2, 4, 8), window_size=(2, 3, 3)),
        SEED, 4, 24, what="swin adapt small slice, cossim", cossim=True)
    lap("phase 19, small slices of the engine's other modes")
    tanet_modes = [tanet, tanet_bf16]
    for what, kw in (
            ("BNS", dict(tta=dict(stat_reg="BNS"))),
            ("cossim", dict(tta=dict(stat_reg="cossim",
                                     stat_type=("temp",)))),
            ("tta_epoch_adapt", dict(epoch=True))):
        _counts, summary = phase_full_slice(SEED, TANET_MODE_VIDEOS, card,
                                            what=what, warmup=1, **kw)
        tanet_modes.append(summary)
    lap("phase 20, TANet under BNS, cossim and the epoch-style loop")
    # phase 23 under the same modes: the bfloat16 TANet's small slices card
    # against CPU at phase 23's bounds, then its full-size streams
    for what, kw in (
            ("BNS", dict(tta=dict(stat_reg="BNS"))),
            ("cossim", dict(tta=dict(stat_reg="cossim",
                                     stat_type=("temp",)))),
            ("tta_epoch_adapt", dict(epoch=True))):
        phase_small_slice(SEED, what=f"small slice (bfloat16, {what})",
                          dtype="bfloat16", **kw)
        _counts, summary = phase_full_slice(SEED, BF16_MODE_VIDEOS, card,
                                            what=what, warmup=1,
                                            dtype="bfloat16", **kw)
        tanet_modes.append(summary)
    lap("phase 23, TANet bfloat16 under BNS, cossim and the epoch-style "
        "loop")
    phase_swin_card_vs_cpu(
        "swin small slice", _swin_cfg(
            t=4, hw=24, embed_dim=8, depths=(1, 1, 2, 1),
            num_heads=(1, 2, 4, 8), window_size=(2, 3, 3)),
        SEED, (2, 1, 2), 4, 24)
    phase_swin_card_vs_cpu("swin-B width, depths (2,2,2,1)",
                           _swin_cfg(depths=(2, 2, 2, 1)), SEED, (1,), 16, 224)
    lap("phases 7-8, Swin card against CPU")
    forward_launches, stats, sd, logits = phase_swin_full_slice(
        _swin_cfg(), SEED, card)
    lap("phase 9, Swin-B forward slice")
    tiny = dict(embed_dim=8, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                window_size=(2, 3, 3))
    phase_swin_adapt_small(_swin_cfg(t=4, hw=24, **tiny), SEED, 4, 24)
    launches, packed = phase_swin_adapt_full(_swin_cfg(), sd, stats, SEED,
                                             card)
    lap("phases 10-11, Swin adapt slices")
    for row in swin_rows:
        # the adapt stream's count; the forward-only paths' beside it
        row["launches"] = launches[row["name"]]
        row["launches_forward_paths"] = forward_launches[row["name"]]

    # the projection-fused routes: small slices, then the full ones
    for route in ("proj", "ln_proj"):
        phase_swin_card_vs_cpu(
            f"swin small slice ({route})", _swin_cfg(t=4, hw=24, **tiny),
            SEED, (2, 1, 2), 4, 24, attn_route=route)
        phase_swin_adapt_small(_swin_cfg(t=4, hw=24, **tiny), SEED, 4, 24,
                               attn_route=route)
    lap("phase 13, small slices of the projection-fused routes")
    fused_forward, ln_stats, _sd, ln_logits = phase_swin_full_slice(
        _swin_cfg(), SEED, card, attn_route="ln_proj",
        eval_videos=SWIN_PROJ_EVAL_VIDEOS, sd=sd)
    stat_err = _compare_stats("swin ln_proj against packed", ln_stats, stats,
                              list(stats))
    logit_err = check_close("swin ln_proj against packed, eval logits",
                            ln_logits, logits, 2e-3, 2e-4)
    print(f"swin full slice, ln_proj against packed: {len(stats)} source "
          f"statistics max abs err {stat_err:.2e}, eval logits max abs err "
          f"{logit_err:.2e}", flush=True)
    ln_launches, ln_proj = phase_swin_adapt_full(
        _swin_cfg(), sd, stats, SEED, card, attn_route="ln_proj",
        n_videos=SWIN_LN_PROJ_VIDEOS, warmup=2)
    proj_launches, proj = phase_swin_adapt_full(
        _swin_cfg(), sd, stats, SEED, card, attn_route="proj",
        n_videos=SWIN_PROJ_VIDEOS, warmup=1)
    for row in proj_rows:
        by_route = ln_launches if "ln_proj" in row["name"] else proj_launches
        row["launches"] = by_route[row["name"]]
        row["launches_forward_paths"] = fused_forward[row["name"]]
    interleaved = phase_routes_interleaved(_swin_cfg(), sd, stats, SEED, card)
    lap("phase 14, Swin-B slices of the projection-fused routes")

    # the per-(head, window) route and both branches of the MLP: small
    # slices.  embed 16 over four stages at 48 x 48 gives widths 16 to 128,
    # whose last stage runs norm2 inside the LayerNorm-MLP kernel and the
    # others apart (the embed-8 slices above take the latter at every stage)
    both = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                window_size=(2, 3, 3))
    for route, hw_, kw in (("heads", 24, tiny), ("heads", 48, both),
                           (None, 48, both)):
        name = f"embed {kw['embed_dim']} at {hw_}"
        phase_swin_card_vs_cpu(
            f"swin small slice, {name} ({route or 'packed'})",
            _swin_cfg(t=4, hw=hw_, **kw), SEED, (2, 1, 2), 4, hw_,
            attn_route=route)
        phase_swin_adapt_small(_swin_cfg(t=4, hw=hw_, **kw), SEED, 4, hw_,
                               attn_route=route,
                               what=f"swin adapt small slice, {name}")
    lap("phase 16, small slices of the heads route and both MLP branches")

    # Swin-T at full width and depth: packed, then "heads"
    cfg_t = _swin_cfg(**SWIN_MODELS["swin_t"])
    t_forward, t_stats, t_sd, t_logits = phase_swin_full_slice(
        cfg_t, SEED, card, eval_videos=SWIN_T_STAT_EVAL_VIDEOS, what="swin-T")
    t_launches, t_packed = phase_swin_adapt_full(
        cfg_t, t_sd, t_stats, SEED, card, n_videos=SWIN_T_VIDEOS,
        what="swin-T")
    th_forward, th_stats, _sd, th_logits = phase_swin_full_slice(
        cfg_t, SEED, card, attn_route="heads",
        eval_videos=SWIN_T_STAT_EVAL_VIDEOS, sd=t_sd, what="swin-T")
    stat_err = _compare_stats("swin-T heads against packed", th_stats,
                              t_stats, list(t_stats))
    logit_err = check_close("swin-T heads against packed, eval logits",
                            th_logits, t_logits, 2e-3, 2e-4)
    print(f"swin-T full slice, heads against packed: {len(t_stats)} source "
          f"statistics max abs err {stat_err:.2e}, eval logits max abs err "
          f"{logit_err:.2e}", flush=True)
    th_launches, t_heads = phase_swin_adapt_full(
        cfg_t, t_sd, t_stats, SEED, card, attn_route="heads",
        n_videos=SWIN_T_VIDEOS, what="swin-T")
    bh_launches, b_heads = phase_swin_adapt_full(
        _swin_cfg(), sd, stats, SEED, card, attn_route="heads",
        n_videos=SWIN_B_HEADS_VIDEOS, warmup=1)
    for row in unfused_rows:
        by_route, fwd_paths = ((th_launches, th_forward)
                               if "heads" in row["name"]
                               else (t_launches, t_forward))
        row["launches"] = by_route[row["name"]]
        row["launches_forward_paths"] = fwd_paths[row["name"]]
        if "heads" in row["name"]:
            row["launches_swin_b"] = bh_launches[row["name"]]
    lap("phase 17, Swin-T slices and Swin-B under the heads route")
    # Video Swin-B at bfloat16: a small slice card against CPU, the full
    # stream, float32 against bfloat16 trajectories, then its kernels (whose
    # CUDA graphs would otherwise stand in the stream's peak memory)
    phase_bf16_swin_small(SEED)
    lap("phase 26, bfloat16 Swin small slice")
    b16_launches, b16 = phase_bf16_swin_full(_swin_cfg(), sd, stats, SEED,
                                             card)
    lap("phase 27, Swin-B bfloat16 stream")
    swin_gate = phase_bf16_swin_trajectories(_swin_cfg(), sd, stats, card,
                                             GATE_VIDEOS)
    lap("phase 28, Swin-B float32 against bfloat16 trajectories")
    dtype_turns = phase_bf16_swin_interleaved(_swin_cfg(), sd, stats, SEED,
                                              card)
    lap("phase 29, Swin-B float32 and bfloat16 steps in turns")
    # phase 27 under the other modes vitta_tpu runs on Video Swin: small
    # slices card against CPU, then Swin-B's streams
    b16_modes = []
    for mode, kw in (("cossim", dict(tta=dict(stat_reg="cossim",
                                               stat_type=("temp",)))),
                     ("tta_epoch_adapt", dict(epoch=True))):
        phase_bf16_swin_small(SEED, what=f"swin small slice (bfloat16, "
                              f"{mode})", **kw)
        b16_modes.append(phase_bf16_swin_modes(_swin_cfg(), sd, stats, SEED,
                                               card, mode))
    lap("phase 27, Swin-B bfloat16 under cossim and the epoch-style loop")
    # Video Swin-T at bfloat16: small slices on both routes, the full
    # streams, float32 against bfloat16 trajectories (its kernels in phase
    # 30, after phase 25)
    for route in ("packed", "heads"):
        phase_bf16_swin_small(SEED, model=BF16_SWIN_T_SMALL, route=route,
                              what=f"swin-T small slice (bfloat16, {route})")
    lap("phase 31, bfloat16 Swin-T small slices")
    t16_launches, t16_packed = phase_bf16_swin_full(
        cfg_t, t_sd, t_stats, SEED, card, n_videos=SWIN_T_BF16_VIDEOS,
        what="swin-T")
    t16h_launches, t16_heads = phase_bf16_swin_full(
        cfg_t, t_sd, t_stats, SEED, card, n_videos=SWIN_T_BF16_HEADS_VIDEOS,
        warmup=1, attn_route="heads", what="swin-T")
    lap("phase 32, Swin-T bfloat16 streams")
    swin_t_gate = phase_bf16_swin_trajectories(cfg_t, t_sd, t_stats, card,
                                               SWIN_T_GATE_VIDEOS,
                                               what="Swin-T")
    lap("phase 33, Swin-T float32 against bfloat16 trajectories")
    # Video Swin at bfloat16 under the projection-fused routes (rows 16-19):
    # small slices card against CPU, the Swin-B streams, one step of each
    # route in turns (their kernels in phases 34-35, after phase 30)
    for route in ("proj", "ln_proj"):
        phase_bf16_swin_small(SEED, route=route,
                              what=f"swin small slice (bfloat16, {route})")
    lap("phase 36, bfloat16 small slices of the projection-fused routes")
    b16l_launches, b16_ln_proj = phase_bf16_swin_full(
        _swin_cfg(), sd, stats, SEED, card, n_videos=BF16_PROJ_VIDEOS,
        warmup=1, attn_route="ln_proj")
    b16p_launches, b16_proj = phase_bf16_swin_full(
        _swin_cfg(), sd, stats, SEED, card, n_videos=BF16_PROJ_VIDEOS,
        warmup=1, attn_route="proj")
    lap("phase 37, Swin-B bfloat16 streams under ln_proj and proj")
    bf16_interleaved = phase_routes_interleaved(_swin_cfg(), sd, stats, SEED,
                                                card, dtype="bfloat16")
    lap("phase 38, Swin-B bfloat16 steps of the three routes in turns")
    # the loader chain on both models at full width
    from vitta_tpu_torch.adapt.engine import VittaEngine
    from vitta_tpu_torch.data.dataset import SwinVideoDataset, TANetVideoDataset
    from vitta_tpu_torch.models import get_model
    tanet_engine, _rng = _tanet_engine(_cfg(16, 101), SEED)
    loader = {"TANet": phase_loader(card, "TANet", tanet_engine.cfg,
                                    tanet_engine, TANetVideoDataset)}
    del tanet_engine
    swin_engine = VittaEngine(get_model(_swin_cfg(), attn_route="packed"),
                              _swin_cfg(), sd, stats)
    loader["swin-B"] = phase_loader(card, "swin-B", swin_engine.cfg,
                                    swin_engine, SwinVideoDataset)
    del swin_engine
    lap("phase 39, the loader chain on TANet and Swin-B")
    # the baselines and the CLI: card against CPU, then through evaluate at
    # full size; the sweep driver's kill and --resume
    phase_baselines_small()
    baseline_times = phase_baselines(card)
    lap("phase 40, the baselines")
    cli = phase_cli_resume(card)
    lap("phase 41, the CLI's sweep, mid-stream checkpoint and --resume")
    # the model zoo: its kernels at the new shapes, card against CPU, each
    # model's full stream, the Kinetics-400-C and SSv2-C drivers
    zoo_rows = phase_zoo_kernels(dev)
    lap("phase 42, the model zoo's kernels")
    phase_zoo_small()
    lap("phase 43, the model zoo card against CPU")
    zoo = phase_zoo_full(card)
    for row in zoo_rows:
        kind, d, model = row["name"].split("_", 2)
        if kind == "bn":                      # bn_stats_{fwd,bwd}_{model}
            d, model = model.split("_", 1)
            row["launches"] = zoo[model][0][f"bn_stats_{d}"]
        else:                                 # {ln,mlp}_{fwd,bwd}_videomae
            row["launches"] = zoo[model][0][f"{kind}_{d}"]
    lap("phase 44, the model zoo's streams")
    phase_zoo_drivers(card)
    lap("phase 45, the Kinetics-400-C and SSv2-C drivers")
    # stream parallelism, the trainer and the entry
    parallel = phase_parallel_streams(card)
    lap("phase 46, two TANet streams sharing the card")
    par_sweep = phase_parallel_sweep(card)
    lap("phases 47-48, the parallel sweep and sharded_validate")
    trainer = phase_trainer(card)
    lap("phase 49, the trainer")
    phase_entry(card)
    lap("phase 50, the entry and its multi-process dry run")
    # Video Swin's layout variants: small slices card against CPU, then the
    # forms of Swin-B and Swin-T at full size in turns
    phase_layout_small()
    lap("phase 51, Swin layout variants, small slices card against CPU")
    phase_layout_forms(card, (sd, stats), (t_sd, t_stats))
    lap("phases 52-53, Swin-B and Swin-T layout forms in turns")
    # phase 21 at bfloat16 and phase 25 time CUDA graphs: after the
    # streams, whose peak memory their cuBLAS workspace would stand in
    wgmma_rates = phase_wgmma_rates(dev)
    lap("phase 21, gemm_wgmma_bf16's rates")
    swin_bf16_rows = phase_bf16_swin_kernels(dev)
    for row in swin_bf16_rows:
        row["launches"] = b16_launches[row["name"][:-len("_bf16")]]
    lap("phase 25, bfloat16 Swin kernels")
    swin_t_bf16_rows = phase_bf16_swin_t_kernels(dev)
    for row in swin_t_bf16_rows:
        key = row["name"][:-len("_bf16")].replace("mlp_rows_", "mlp_")
        by_route, videos = ((t16h_launches, SWIN_T_BF16_HEADS_VIDEOS)
                            if "heads" in key
                            else (t16_launches, SWIN_T_BF16_VIDEOS))
        row["launches"] = by_route[key]
        row["launches_a_step"] = by_route[key] / videos
    lap("phase 30, bfloat16 Swin-T kernels")
    proj_bf16_rows = phase_bf16_proj_kernels(dev)
    for row in proj_bf16_rows:
        key = row["name"][:-len("_bf16")]
        by_route = b16l_launches if "ln_proj" in key else b16p_launches
        row["launches"] = by_route[key]
        row["launches_a_step"] = by_route[key] / BF16_PROJ_VIDEOS
    lap("phases 34-35, bfloat16 projection-fused attention kernels")
    for s in tanet_modes:
        print(f"TANet, {s['mode']}, {s['dtype']}: median "
              f"{s['median_ms']:.3f} ms/video (min "
              f"{s['min_ms']:.3f}, max {s['max_ms']:.3f}, {s['videos']} "
              f"videos), {s['chosen']} chosen layers, host "
              f"{fmt(s.get('host_ms'))} ms, device busy "
              f"{fmt(s.get('device_busy_ms'))} ms, idle share "
              f"{fmt(s.get('idle_share'))}, peak memory {s['peak_gib']:.3f} "
              f"GiB; on {card}", flush=True)
    for name, (_counts, s) in zoo.items():
        print(f"zoo {name} adapt step: median {s['median_ms']:.3f} ms/video "
              f"(min {s['min_ms']:.3f}, max {s['max_ms']:.3f}, {s['videos']} "
              f"videos), host {fmt(s.get('host_ms'))} ms, device busy "
              f"{fmt(s.get('device_busy_ms'))} ms, idle share "
              f"{fmt(s.get('idle_share'))}, peak memory {s['peak_gib']:.3f} "
              f"GiB; on {card}", flush=True)
    for s in (packed, ln_proj, proj, b_heads, t_packed, t_heads, b16,
              t16_packed, t16_heads, b16_ln_proj, b16_proj, *b16_modes):
        print(f"{s['model']} adapt step, route {s['route']}"
              f"{', bfloat16' if s.get('dtype') == 'bfloat16' else ''}: median "
              f"{s['median_ms']:.3f} ms/video (min {s['min_ms']:.3f}, max "
              f"{s['max_ms']:.3f}, {s['videos']} videos), host "
              f"{fmt(s.get('host_ms'))} ms, device busy "
              f"{fmt(s.get('device_busy_ms'))} ms, idle share "
              f"{fmt(s.get('idle_share'))}, peak memory {s['peak_gib']:.3f} "
              f"GiB; on {card}", flush=True)
    streams = {"packed": packed, "proj": proj, "ln_proj": ln_proj}
    for route, r in interleaved.items():
        busy = [b for b in r["busy"] if b is not None]
        print(f"swin-B adapt step, route {route}, interleaved with the other "
              f"two: device busy {fmt(statistics.mean(busy) if busy else None)}"
              f" ms, step peak {max(r['peak']):.3f} GiB above the engines' "
              f"memory; peak of its own stream "
              f"{streams[route]['peak_gib']:.3f} GiB; on {card}", flush=True)
    b16_streams = {"packed": b16, "proj": b16_proj, "ln_proj": b16_ln_proj}
    for route, r in bf16_interleaved.items():
        busy = [b for b in r["busy"] if b is not None]
        print(f"swin-B adapt step, bfloat16, route {route}, interleaved with "
              f"the other two: device busy "
              f"{fmt(statistics.mean(busy) if busy else None)} ms, step peak "
              f"{max(r['peak']):.3f} GiB above the engines' memory; peak of "
              f"its own stream {b16_streams[route]['peak_gib']:.3f} GiB; on "
              f"{card}", flush=True)
    print("gemm_tiles rates, TFLOP/s (gemm_tiles, torch.matmul): "
          + json.dumps({k: {c: [round(v, 2) if v else v for v in r]
                            for c, r in calls.items()}
                        for k, calls in gemm_rates.items()}), flush=True)
    print("gemm_wgmma_bf16 rates, TFLOP/s (the core with its epilogue, "
          "torch.matmul at bfloat16): " + json.dumps(
              {k: {c: [round(v, 2) for v in r] for c, r in calls.items()}
               for k, calls in wgmma_rates.items()}), flush=True)
    print("loader chain, ms (host clock): " + json.dumps(
        {m: {k: ({n: round(x, 3) for n, x in v.items()}
                 if isinstance(v, dict) else round(v, 3))
             for k, v in r.items()} for m, r in loader.items()})
          + f"; on {card}", flush=True)
    print("baselines through evaluate, ms/video (host clock) and device "
          "busy ms/video: " + json.dumps(
              {k: [round(v["ms_per_video"], 3), v["busy_ms_per_video"]]
               for k, v in baseline_times.items()})
          + f"; cli sweep {cli['full_s']:.1f} s, resumed "
          f"{cli['resume_s']:.1f} s; on {card}", flush=True)
    print("parallel streams, trainer: " + json.dumps(
        {"parallel_streams": parallel, "parallel_sweep": par_sweep,
         "trainer": {k: v for k, v in trainer.items() if k != "analysis"}})
          + f"; on {card}", flush=True)
    print("TANet fp32 against bf16 trajectories: " + json.dumps(gate),
          flush=True)
    print("Swin-B fp32 against bf16 trajectories: " + json.dumps(swin_gate),
          flush=True)
    print("Swin-T fp32 against bf16 trajectories: "
          + json.dumps(swin_t_gate), flush=True)
    print("Swin-B float32 and bfloat16 steps in turns, ms: " + json.dumps(
        {d: {k: (round(statistics.median(v), 3) if isinstance(v, list)
                 else v) for k, v in r.items()}
         for d, r in dtype_turns.items()}) + f"; on {card}", flush=True)
    print(json.dumps({"kernels": tam_rows + bn_rows + bf16_rows + swin_rows
                      + proj_rows + unfused_rows + swin_bf16_rows
                      + swin_t_bf16_rows + proj_bf16_rows + zoo_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:   # any failed phase: report it, exit non-zero
        traceback.print_exc()
        sys.exit(1)
