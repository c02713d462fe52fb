#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vitpose_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repo root; one card, nvcc, no args

Phases, each printing its own line(s); any failure exits non-zero and prints
no result:

  env       card name and power limit (nvidia-smi), torch and CUDA versions
  build     every csrc/*.cu built by nvcc for sm_90a, one process each; one
            line per kernel with ptxas's registers, static shared memory and
            spills (any spill fails)
  kernel    K1 (attention_fwd) against its plain version on the card at the
            shapes the serving and training paths give it, the other head
            dims and both sides of the whole-pair boundary (T = 192, 193),
            in every design that takes each shape; median times of each
            design (the whole pair and the tiled one in turns: tiled, pair,
            pair, tiled), back to back and on the device alone (CUDA graph),
            of the plain version and of one PyTorch library call, and the
            card's bound for the same work
  serve     full-width ViTPose-B 256x192 (bf16, K1 attention, flip test, UDP
            decode) through init_pose_model + inference_top_down_pose_model
            on a seeded 480x640 image with 8 boxes: exactly 12 blocks x 2
            passes = 24 K1 launches, all of the whole-pair design, every
            tensor on the card, every keypoint finite and inside its padded
            box; then img/s of a 256-crop batch
  ops       K1 and K2 as torch.library custom ops: opcheck of
            vitpose::attention_fwd and attention_bwd on CUDA at
            (2,192,12,64) bf16; one K3 call through the ops counts one
            whole-pair launch of each kernel; the dispatcher priced against
            the same kernels called directly (the earlier path: the ctypes
            wrappers under a Python autograd.Function): host us per K1 call
            at the 8-box shape, the 256-crop serve batch and one train step,
            each in turns (op, direct, direct, op)
  serve-ref the same weights on CUDA (K1) and on the CPU (plain attention),
            2 boxes, in f32 (TF32 off) and in bf16: f32 heatmaps and decisive
            keypoints agree; the bf16 CUDA path is as close to the f32 CPU
            answer as the bf16 CPU path is (within BF16_FACTOR)
  int8      Int8Linear (W8A8, torch._int_mm) on the card against its CPU
            path at the four ViT-B products (qkv, proj, fc1, fc2; bf16 in
            and out, one 8-box pass of rows): equal weight and activation
            codes, an exact int32 product, equal outputs; at a 256-crop
            pass's rows the times of _int_mm, the bf16 matmul it replaces,
            the quantise + dequantise passes alone and the whole layer
  serve-int8 full-width ViTPose-B 256x192 through int8_serving_config (W8A8
            MLP, qkv and proj; bf16, K1, tanh GELU as the server's --fast)
            at skip 0 and 1, scales calibrated on the scene's crops: 24 K1
            launches per 8-box call (all whole-pair) and 96 / 80 _int_mm,
            keypoints finite, inside their padded boxes and near the --fast
            bf16 path's; the 256-crop batch of int8 and of --fast bf16 timed
            in turns
  deploy    the HTTP server (vitpose_tpu_torch.tools.serve, build_server on
            port 0) on the card: the COCO-B config in its default mode,
            --fast and --int8-qkv (--calib-dir of the scene's person crops),
            and the default --variant s with --fast (K1 at head dim 32),
            each from shaped weights saved as a .pth; 1-box and 8-box
            requests answer exactly what the direct API call gives, K1 and
            _int_mm launches per request, p50/p99 latency beside the
            direct call's median
  export    the export CLI (vitpose_tpu_torch.tools.export) on the COCO-B
            config at --batch 8 with shaped weights saved as a .pth, then
            load_exported of its .pt2 in this process: 24
            vitpose.attention_fwd in the graph and 24 K1 launches per call,
            heatmaps against eager `infer` within EXPORT_TOL of max |eager|,
            ms per call of the exported program beside eager at batch 8 and
            256 (exported in-process), in turns
  demos     the 8 top-down demos (vitpose_tpu_torch.demo.*) on the card, on
            a seeded 480x640 image with 3 boxes and a 4-frame MJPG video
            of it: the six that take --variant get the COCO-B config and the
            shaped .pth (24 K1 launches per frame), the face demos their f32
            ViT-S default with shaped 68-joint weights (0 K1); every output
            written, videos read back frame for frame; frames/s over main;
            every shape K1 launched at is a KERNEL_CASES one (also in
            export and webcam)
  webcam    the examples/pose_estimation.py runner dict as
            tools/run_webcam.py loads it, its pose node on the COCO-B config
            and the shaped .pth, a 16-frame video as the camera, headless,
            max_frames 10: synchronous, then threaded (the config's
            synchronous=False; K1 on the pose node's own thread) with the
            camera paced at a third of the model chain's rate measured in
            the synchronous run (at most the config's 20 frames/s); no node
            thread raises, every one is alive when the last frame is shown
            and has ended when the run returns; frames shown and inferred
            (at least half the frames shown threaded, all of them
            synchronous), 24 K1 launches per inferred frame, frames/s; then
            tools/run_webcam.py itself with --cfg-options for the camera,
            show and max_frames
  eval      the evaluation CLI (vitpose_tpu_torch.tools.test) on the COCO-B
            config file (ViTPose-B 256x192 bf16, K1, flip test, UDP, batch
            64, canvas 640), pointed by --cfg-options at a synthetic COCO val
            set written to a temporary directory (30 JPEGs, 4 of them
            larger than the canvas; 120 detection boxes, so a full batch
            and a short one of 56; GT joints at each box's peak plus seeded
            jitter) and at the shaped weights saved as a .pth: exactly 24 K1
            launches per batch, all whole-pair, and no K2; the ten COCO
            stats, AP in (0, 1); then the same run timed: every val-step
            tensor on the card, one finite result per box, boxes/s (decode
            included), the host's decode and batch time alone, the card's
            busy time (torch.profiler) and peak memory; after eval-ref,
            the CLI once more with --int8 --int8-skip 1 --show-dir: K1 and
            _int_mm launches, AP beside the bf16 AP, one drawing per image
  eval-ref  16 of those boxes through the same config on CUDA in f32 (TF32
            off) and bf16 and on the CPU in f32: f32 keypoints agree as
            serve-ref's do and f32 AP within EVAL_REF_AP_TOL; bf16 AP beside
            the f32 AP, within EVAL_REF_BF16_AP_TOL
  kernel-bwd K2 (attention_bwd) in the same way at the training shapes and
            the other head dims and lengths (the library call is SDPA's
            backward, timed as fwd+bwd minus fwd); then one K3 check:
            gradients through `attention` on CUDA equal the plain backward
  train     full-width ViTPose-B 256x192 training steps (bf16, K1 + K2
            attention, drop_path 0.3, the COCO-B optimizer, batch 64) from
            seeded synthetic records on 640x640 canvases, augmented on the
            host (flip, half-body, scale, rotation) and cropped with UDP
            targets on the card: exactly 12 K1 and 12 K2 launches per step,
            all of the whole-pair designs, every tensor on the card, finite
            loss and gradients, parameters
            and BN statistics changed, acc_pose in [0, 1]; ms per step, and
            a torch.profiler view of two more steps: kernel time per step,
            the card's idle share and the kernels that take the most time
  train-ref the same seeded weights and batch of 2 crops, drop_path 0, on
            CUDA (K1 + K2) and on the CPU (plain attention): in f32 (TF32
            off) loss, grad_norm, every gradient, and every parameter
            tensor and BN statistic after 2 steps agree; in bf16 CUDA is as close to the
            f32 CPU answer as the bf16 CPU path is (within BF16_FACTOR)
  train-loop the training CLI (vitpose_tpu_torch.tools.train) on the COCO-B
            config file at full width (ViTPose-B 256x192 bf16, K1 + K2,
            drop_path 0.3, batch 64, UDP targets), pointed by --cfg-options
            at a synthetic COCO train set (140 persons: 2 steps per epoch)
            and val set (128 boxes: 2 batches), starting from the shaped
            weights (load_from), 2 epochs with an evaluation and a
            checkpoint after each, logging every step: exactly 12 K1 + 12
            K2 launches per step and 24 K1 per val batch, all whole-pair;
            finite metrics, best.pth written; step wall time and img/s, the
            data_time share, the card's idle share (the train phase's kernel
            time over the step), AP per epoch, checkpoint bytes, peak memory
  train-resume the epoch-0 checkpoint restored into a fresh runner state
            equals the saved one bit for bit (parameters, BN statistics,
            AdamW moments and step counts on the card, lr, schedule, step);
            restore and save times; epoch 1 redone with --resume in a copy of
            the work dir gives the uninterrupted run's losses, final weights
            and AP exactly; best.pth loads through init_pose_model and the
            evaluation CLI scores it to the AP the runner logged
  remat     ViTPose-B bf16 train steps at batch 64 without remat and under
            remat 'full', 'attn' and 'dots', from the same weights, batch and
            DropPath seeds: K1 launches 12/24/12/24 and K2 12 in a step,
            gradients within REMAT_GRAD_TOL of no remat, the peak memory
            above the resident state, and step times in turns
  moe-train the training CLI on the ViTPose+-B config file (6 experts of
            part_dim 192, 6 heads of 17/14/16/17/17/133 channels, bf16, UDP,
            batch 128, K1 + K2 turned on by --cfg-options) over six seeded
            synthetic train sets in their own formats (COCO, AIC, MPII,
            AP-10K, APT-36K, COCO-WholeBody; 1 batch each, 6 steps in one
            epoch) and a COCO val set, `pretrained` the shaped dense ViT-B
            backbone: every expert's features first equal the dense
            backbone's; exactly 12 K1 + 12 K2 launches per step and 24 K1
            per val batch, all whole-pair; every dataset in the log, every
            other head's loss exactly 0, finite metrics, best.pth under the
            mmpose names; model_split of best.pth and the evaluation CLI on
            its COCO part with the COCO-B config give the runner's AP; step
            wall time, img/s, data_time share, kernel time per step, peak
            memory, checkpoint bytes and phase times
  moe-ref   two ViTPose+ MoE steps (make_moe_train_step) at full ViTPose+-B
            width and depth on 3 crops whose datasets mix within each batch
            (so the blocks route rows per expert), drop_path 0, on CUDA
            (K1 + K2) and on the CPU (plain attention): f32 (TF32 off)
            losses, grad_norm, gradients, parameters, every expert's rows
            and BN statistics within MOE_REF_TOL; bf16 CUDA as close to
            the f32 CPU
            answer as the bf16 CPU path is (within BF16_FACTOR)
  cnn-serve HRNet-W32 (bf16) and ResNet-50 (f32) from the zoo's configs
            through init_pose_model with seeded weights, TF32 as torch
            defaults it: one 8-box call (every tensor on the card,
            keypoints finite and inside their boxes), then the 256-crop
            flip-tested batch timed, the card's busy time, conv MACs and
            BN'd elements per crop from the shapes; 0 K1 and K2 launches
  cnn-ref   both at full width on 2 boxes, CUDA against the CPU: f32 (TF32
            off) heatmaps within CNN_HM_RTOL of their largest value and
            decisive keypoints within KP_TOL_PX; HRNet-W32 in bf16 as close
            to the f32 answer as the bf16 CPU path (BF16_FACTOR), every
            joint decoded at a cell within twice that error of the f32
            maximum
  cnn-eval  the evaluation CLI on the HRNet-W32 config over a synthetic
            COCO val set of 128 boxes: 0 K1/K2, the stats, --int8 raises,
            boxes/s, the host's share and the card's idle share
  cnn-train the training CLI on the ResNet-50 config, one epoch of 2 steps
            at batch 64 (step time, img/s, data_time share, peak memory,
            the epoch checkpoint), then --resume for a second epoch; the
            HRNet-W32 and ResNet-50 steps at batch 64 with a profiled step
            each; cnn-train-ref: two ResNet-50 steps at batch 2 of the
            config's 192x256 crops, f32 on
            CUDA and on the CPU against float64 on the CPU: CUDA's
            distance within CNN_REF_FACTOR times the CPU's
  cnn-apps  tools/serve.py on the HRNet-W32 config (1-box requests equal
            the direct call, p50/p99) and tools/export.py at --batch 8
            --no-flip (the reloaded program against eager, both timed)

  cnn-more-serve  the single-stage backbones of ROADMAP item 12a: ten zoo
            configs at 256x192, full width and depth, seeded weights
            (coco/{resnext50, seresnet50, seresnext50, scnet50, resnest50
            (bf16), vgg16_bn (bf16), alexnet (bf16), shufflenetv1,
            vipnas_res50, vipnas_mbv3}_coco_256x192.py) as cnn-serve runs
            them, after count_ops is held to a hand count of a grouped
            conv and a grouped transposed conv
  cnn-more-ref  all ten in f32 (TF32 off), CUDA against the CPU on 2
            boxes, as cnn-ref; ResNeSt-50 and ViPNAS-MobileNetV3 also in
            bf16 under its BF16_FACTOR rule
  cnn-more-train  the training CLI on vipnas_res50 (one epoch of 2 steps at
            batch 64, then --resume for a second epoch), the other nine's
            steps at batch 64, and two ViPNAS-ResNet-50 steps at batch 2,
            full width and depth, f32 CUDA and CPU against f64 (grouped
            convs, context blocks, the grouped deconv head) under
            cnn-train-ref's rule
  cnn-more-eval  the evaluation CLI on vipnas_mbv3 over 128 synthetic
            boxes, as cnn-eval

  cnn-ms-serve  the multi-stage and lightweight CNNs of ROADMAP item 12b:
            seven zoo configs at full width and depth in their dtypes
            (coco/{mspn50, 3xrsn50, litehrnet_18 (f32), cpm, mobilenetv2,
            shufflenetv2}_coco_256x192.py, coco/hourglass52_coco_256x256.py)
            as cnn-serve runs them
  cnn-ms-ref  all seven in f32 (TF32 off), CUDA against the CPU on 2
            boxes, as cnn-ref
  cnn-ms-train  the training CLI on 3xrsn50 (one epoch of 2 steps at batch
            64, then --resume: multi-stage supervision across three
            stages' skips; its step times), the other six's steps at batch
            64, and two steps of MSPN-50 and of Lite-HRNet-18 at batch 2
            under cnn-train-ref's rule
  cnn-ms-eval  the evaluation CLI on mspn50 (the 'megvii' decode) over 128
            synthetic boxes, as cnn-eval

  bu-serve  HigherHRNet-W32 512 (f32, seeded weights, the heatmap biases
            shifted so that at most about BU_KEEP peaks per joint pass the
            parser's threshold on each image of the phase and the tags
            scaled so that they group into a few people, as trained
            weights give) through init_pose_model,
            inference_bottom_up_multi_scale and
            inference_bottom_up_pose_model over 5 images of mixed sizes:
            every tensor of the forward + flip + reduction on the card,
            finite poses, 0 K1/K2; per image the card's half (resize,
            forward, flip, aggregation) and the host's grouping timed
            apart, images/s, the card's idle share
  bu-ref    the flagship, its UDP twin and the HRNet-W32 AE simple head,
            CUDA against the CPU in f32 (TF32 off) on 2 images, a
            landscape and a portrait one: aggregated
            heatmaps and tags within BU_MAP_RTOL, grouped poses within
            BU_POSE_TOL_PX where both keep the same candidates (the images
            where they do not are counted)
  bu-eval   the evaluation CLI on the flagship config over 4 synthetic
            images (a crowd region in compressed RLE, one in polygons; GT
            from the seeded model's jittered poses): AP in (0, 1], 0
            K1/K2, images/s, the card's and the host's share
  bu-train  the training CLI on the flagship config at batch 24, 512 ->
            (128, 256): 2 epochs of 2 steps; epoch 1 redone with --resume
            from the epoch-0 checkpoint equals it bit for bit; step time,
            img/s, data_time share, peak
            memory, one profiled step's kernel time and launches
  bu-apps   the 3 bottom-up demos (ViT-S f32 base 256, K1) on an image and
            a 4-frame video: 24 K1 launches per frame at held shapes,
            frames/s
  bu-ms     Hourglass-AE (4 stacks) and MobileNetV2-AE 512 (f32) through
            both API functions on 2 images of 2 sizes (the stages the model
            gives and the one the protocol keeps), CUDA against the CPU on
            2 images as bu-ref, and one training step each at the config's
            batch: finite losses, BN statistics moved, 0 K1/K2

  td-rest-serve  the rest of top-down: HRFormer-B (f32) and DeepPose-Res50
            (f32, the regression head) as cnn-serve runs them;
            td-rest-attention: HRFormer-B's window attention in the
            256-crop batch by CUDA events around every call (the partition
            copies, the qkv and proj Linears, the einsums with the bias and
            softmax), its MACs and bytes, and the batch's top kernels
  td-rest-ref  HRFormer-B and -S in f32 (TF32 off), CUDA against the CPU
            on 4 boxes, as cnn-ref
  td-rest-train  steps at batch 64 of HRFormer-B, DeepPose (smooth L1),
            HRNet-W32 with CombinedTarget and ResNet-50 with AdaptiveWing;
            HRFormer-B's train-ref under cnn-train-ref's rule at 96x128
            crops (HRFORMER_REF_CROP; its float64 run starts in a child
            process, F64Run, before the cnn group); the training
            CLI on the photometric config for 2 steps (data_time share)
  td-rest-eval  the evaluation CLI on DeepPose over 256 synthetic boxes
            (the regression decode) and on the udp_regress config over 128
            (the UDP CombinedTarget decode), as cnn-eval
  td-rest-video  the evaluation CLI on the PoseTrack18 HRNet-W32 config
            (1080x1920 frames in two videos, head boxes; poseval's AP per
            part) and the Sub-JHMDB ResNet-50 config (PCK and tPCK per
            part) over small synthetic sets, 0 K1/K2

  pw-serve  the video and 3D group (after td-rest): the PoseWarper config
            at full width (HRNet-W48 384x288, the neck at 17 channels, 128
            inner, 20 BasicBlocks, dilations 3-24, 17 deformable groups),
            f32, its identity warps replaced by seeded ones (shape_warps:
            fractional offsets of a few pixels, many samples past the
            border, checked; perturbed deformable kernels): a 16-window
            batch of 5 frames with the flip test and the decode, timed
            (windows/s), its MACs, the neck and the deformable convs alone
            by CUDA events, peak memory, 0 K1/K2
  pw-ref    one 5-frame window, CUDA against the CPU in f32 (TF32 off), as
            cnn-ref
  pw-eval   the evaluation CLI on the PoseWarper config over a synthetic
            two-video PoseTrack18 set whose supports are real neighbouring
            frames (a folder of %06d.jpg per video, nframes): poseval's AP
  pw-train  the training CLI at batch 16 (2-frame windows), 2 steps, then
            --resume: trans_layer bit for bit as built; timed steps (peak
            memory, a profiled step's idle share); the train-ref at
            PW_REF_CROP against the port's f64 run (a child process started
            before td-rest)
  lift      the 243-frame lifter on 1024 windows, timed; the 27-frame
            semi-supervised lifter (pose and trajectory) CUDA against the
            CPU; the training CLI, 2 steps and --resume, on the
            semi-supervised config (the warm-up crossed) and on
            SimpleBaseline3D (stats .pkl); the evaluation CLI on an H36M
            set and a 3DHP set (3DPCK, 3DAUC)
  lift-demos  both body3d demos with the COCO-B config's 2D stage and
            shaped weights: 24 K1 launches per frame at held shapes, every
            frame's lifted poses written (the card machine has no
            matplotlib: lifted_pose_writer stands in for the drawing, which
            the CPU tests hold)

  fam-ih    the one-config families (after vid3d): InterHand3D-Res50 at
            256x256 (the zoo config, full width): inference_interhand_3d_model
            on a 64-box image (the decode with the soft-argmax root depth,
            the back-projection), timed; CUDA against the CPU on 2 crops;
            steps at batch 16; the train-ref at the config's 256x256
            against the port's f64 run (computed with the other families'
            in a child process started before the cnn group, FamRefs;
            family_ref_runs: hold_train_ref's
            rule, CUDA's parameters below FAM_REF_PARAMS_CAP from f64, its
            step-1 loss and gradients against the CPU's; an unmoved CUDA
            state and a zeroed gradient must fail these); the training CLI
            for 2 steps and --resume and the evaluation CLI on a synthetic
            InterHand2.6M set
  fam-mesh  HMR-Res50 at 224x224 with its 1024-wide discriminator: the
            mesh API on 64 boxes, CUDA against the CPU, adversarial steps at
            batch 64 (the mean parameters unmoved), the train-ref at
            224x224, both CLIs on synthetic mixed sets and a Mosh prior
  fam-vp    VoxelPose at the config's sizes (80x80x20 space, 64^3 cubes, 5
            views): the forward with its host proposals (the centre net's
            output bias shifted so that about 5 pass), the projections
            against the V2VNets by CUDA events; CUDA against the CPU (the
            centre volume, the joints of 2 proposals given the same ones);
            steps with 10 candidate cubes; the train-ref on a smaller grid
            on two weight seeds (the centre and pose nets' gradients each
            against its own largest; CUDA through ATen's convolutions by
            hold_train_ref's rule, through cuDNN's by family_holds); both
            CLIs on a synthetic Panoptic sequence
  fam-apps  the interhand3d and mesh image demos, and MultiTaskModel on a
            ResNet-50 trunk with a heatmap and a regression head (forward
            and one step); 0 K1 and K2 on every fam path

  dist      training across processes (vitpose_tpu_torch/parallel/):
            init_distributed starts a world-1 NCCL group, and the
            full-width ViTPose-B bf16 step at batch 64 runs with the
            data-parallel hook and ZeRO-1 on a data group of that one
            process (so that their all-reduce and broadcasts run): 12 K1 +
            12 K2 launches, parameters and metrics equal to the plain
            step's, its ms beside the plain step's in turns; meanwhile two
            spawned ranks on the same card (gloo, CUDA tensors; NCCL takes
            one rank a card) each step on half of each batch: ViTPose-B
            with K1 + K2 and ZeRO-1 (the AdamW state split between them),
            its gradients and losses against the one-process step, and
            HRNet-W32 in float64 with its BN over both ranks, its
            gradients and BN statistics against one process's (DIST_*
            tolerances)
  tools     the root tools and the functions that no config reaches
            (ROADMAP items 14 and 15; last), each through its main(argv)
            on the COCO-B config with shaped weights and a synthetic COCO
            set (TOOLS_*): get_flops, benchmark_inference at batch 64
            (flip test, and --int8), speed_test, profile_trace in both
            modes (the Chrome trace must name K1's kernel, and K2's in
            training), tools/test.py beside test_new (the same stats; the
            histogram and the overlays), keypoints2coco against the API,
            publish_model (the published weights' heatmaps bit for bit),
            the int8 sweep (ViT-B f32 with K1) on two grid points,
            overfit_sanity for 2 epochs (ViT-S f32, K1 and K2),
            benchmark_processing, and HybridEmbed (ResNet-50) with 12
            ViT-B blocks in bf16 against the plain attention; every path's
            K1 and K2 launches counted and their shapes held
            (check_shapes_held)
  bench     the seven bench_* analysis tools (the JAX package's
            tools/analysis/bench_*.py; last), each through its main(argv)
            on the card at full width and the tools' own batches (BENCH_*):
            bench_zoo (the ten ZOO models, 2 timed calls each),
            bench_fused_attention, bench_batch_sweep, bench_attn_pack
            (every arm; first K1 on its fused arm's [B, S, H, D] views held
            against the plain version), bench_breakdown, bench_io (64
            JPEGs), bench_train for ViT-B and ViT-H (2 timed calls of 4
            steps) and its fed loop in the canvas and crop modes (192
            JPEGs, 6 timed steps); each tool's K1 and K2 launches held to
            what its code implies and their shapes held, every JSON line
            parsed, every rate finite and positive

Then the cnn, cnn_more, cnn_ms, bottomup, bottomup_ms, td_rest, vid3d, fam,
dist, tools and bench JSON lines (those phases' numbers),
the kernels JSON line (per kernel: the design the main path takes, its
times, the tiled design's times from the same run, bound, library time,
launches in a train step and `launches_per_path`: per serve call, int8
serve call, server request per mode, eval run, int8 eval run, train step,
train-loop run, remat step, moe-train run, exported call, demo frame,
webcam run, each CNN, cnn-more, cnn-ms, bottom-up, bu-ms, td-rest, video
and 3D and fam phase (0), bottom-up demo frame and body3d demo frame, and
the dist phase's world-1 and two-rank steps, and each tools and bench
path; beside
the kernels, the int8 product's launches per path and times, the server's latencies and the
int8 AP, the dispatcher's price, the exported program's times and the
demos' and webcam's frames/s), the nvidia-smi card line and the result
line.

The weights are random (torch.Generator seed 0, inside init_pose_model).
Random heatmaps make the UDP Newton step ill conditioned, so the smoke makes
each person box hold one clear peak: it paints a bright square at every box
centre of a dim random image, turns channel 0 of the patch embedding into a
brightness detector, and carries channel 0 through bump-shaped deconv kernels
onto every joint (`shape_peaks`). Every other weight stays random.
"""
import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
              torch.float32: 67e12}     # f32 outside the tensor cores
# (atol, rtol). f32: summation order. bf16: the output is rounded to bf16 on
# both sides (one step is at most 2^-7 of |o|, inside rtol) and the tiled
# design rounds P to bf16 at a different point (unnormalised; normalised in
# the plain version and the whole-pair design), a few 1e-3 at |o| < 0.5
# (atol)
TOLS = {torch.float32: (1e-5, 1e-5),
        torch.bfloat16: (4e-3, 1e-2)}
# (shape [N,T,H,d], dtype, role). Every bf16 case up to T = 192 runs in both
# designs (the whole pair per block, and the tiled one); T = 192 and 193 are
# the two sides of the plan's boundary (PAIR_MAX_T)
KERNEL_CASES = [
    ((256, 192, 12, 64), torch.bfloat16, 'serving batch 256, ViT-B'),
    ((256, 192, 12, 64), torch.float32, 'serving batch 256, f32'),
    ((8, 192, 12, 64), torch.bfloat16, 'serve call, 8 boxes'),
    ((64, 192, 12, 64), torch.bfloat16, 'training batch 64, ViT-B'),
    ((128, 192, 12, 64), torch.bfloat16, 'ViTPose+ batch 128'),
    ((16, 192, 16, 80), torch.bfloat16, 'ViT-H head dim'),
    ((32, 192, 6, 32), torch.bfloat16, 'ViT-S head dim'),
    ((4, 193, 12, 64), torch.bfloat16, 'one token past the whole pair'),
    ((2, 972, 16, 80), torch.bfloat16, '576x432 inputs'),
    ((4, 72, 12, 64), torch.bfloat16, 'last key tile holds 8 of 64 keys'),
    ((3, 48, 5, 32), torch.float32, 'ragged'),
    ((1, 192, 12, 64), torch.bfloat16, 'webcam whole-frame box, 1 box'),
    ((4, 192, 12, 64), torch.bfloat16, 'demo 3 boxes, bucket 4'),
    ((1, 256, 12, 32), torch.float32, 'bottom-up demos, ViT-S base 256'),
    ((1, 256, 12, 32), torch.bfloat16, 'bottom-up ViT-S base 256, bf16'),
    ((1, 1024, 12, 32), torch.bfloat16, 'bottom-up ViT-S base 512, bf16'),
    ((64, 48, 12, 64), torch.bfloat16, 'HybridEmbed ResNet-50 tokens'),
    ((7, 192, 12, 64), torch.float32, 'int8 sweep, val batch 7, f32'),
    ((12, 48, 4, 32), torch.float32, 'overfit_sanity ViT-S, batch 12'),
    ((32, 192, 12, 64), torch.bfloat16, 'bench_batch_sweep batch 32'),
    ((256, 192, 12, 32), torch.bfloat16, 'bench_zoo ViT-S batch 256'),
    ((256, 192, 16, 64), torch.bfloat16, 'bench_zoo ViT-L batch 256'),
    ((128, 192, 16, 80), torch.bfloat16, 'bench_zoo ViT-H batch 128'),
    ((64, 192, 16, 80), torch.bfloat16, 'bench_train ViT-H batch 64'),
]
BWD_CASES = [
    ((64, 192, 12, 64), torch.bfloat16, 'training batch 64, ViT-B'),
    ((64, 192, 12, 64), torch.float32, 'training batch 64, f32'),
    ((128, 192, 12, 64), torch.bfloat16, 'ViTPose+ batch 128'),
    ((16, 192, 16, 80), torch.bfloat16, 'ViT-H head dim'),
    ((32, 192, 6, 32), torch.bfloat16, 'ViT-S head dim'),
    ((4, 193, 12, 64), torch.bfloat16, 'one token past the whole pair'),
    ((2, 972, 16, 80), torch.bfloat16, '576x432 inputs'),
    ((4, 72, 12, 64), torch.bfloat16, 'last tile holds 8 of 64 rows'),
    ((3, 48, 5, 32), torch.float32, 'ragged'),
    ((12, 48, 4, 32), torch.float32, 'overfit_sanity ViT-S, batch 12'),
    ((64, 192, 16, 80), torch.bfloat16, 'bench_train ViT-H batch 64'),
]
# K2 against its plain version, per output: |err| <= atol * max|ref| +
# rtol * |ref|. f32: summation order. bf16: the outputs are rounded to bf16
# on both sides (one step is 2^-8 of |x|, inside rtol), and K2 rounds P and
# dS to bf16 (2^-9 relative) as operands of the products dV = P^T g,
# dQ = dS k, dK = dS^T q; a CPU emulation of exactly those roundings needs
# atol 0.6e-3 to 1.4e-3 of max|ref| at these shapes (rtol 1e-2), so atol is
# twice that
BWD_TOLS = {torch.float32: (1e-5, 1e-5),
            torch.bfloat16: (3e-3, 1e-2)}
SERVE_CFG = {'variant': 'b', 'dtype': 'bfloat16',
             'backbone_overrides': {'fused_attention': True}}
TRAIN_BATCH = 64                     # configs/base/coco_data.py
CANVAS = 640                         # configs/base/coco_data.py canvas_size
STEPS_PER_EPOCH = 2340               # COCO train2017: 149,813 people / 64
TIMED_STEPS = 5
HM_TOL = (1e-3, 1e-4)               # CUDA vs CPU f32 heatmaps (atol, rtol)
KP_TOL_PX = 0.05                     # CUDA vs CPU keypoints, image pixels
# bf16: max |CUDA bf16 - CPU f32| over heatmaps (and decisive keypoints, plus
# KP_TOL_PX) may be at most this many times max |CPU bf16 - CPU f32|, the
# error of bf16 itself: two bf16 paths that round at different points each
# land about that far from the f32 answer
BF16_FACTOR = 2.0


class Failure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failure(msg)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, calls=10, rounds=5, warmup=3):
    """Time of one fn() on the card: median over `rounds` of a CUDA-event
    timing of `calls` back-to-back calls, divided by `calls`, after warm-up.
    Back to back, the host enqueues the next call while the card runs this
    one, so a call's host overhead shows only where it exceeds its device
    time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(fn, calls=10, rounds=5):
    """Device time of one fn(): `calls` calls captured in one CUDA graph,
    replayed after a warm-up; the median over `rounds` replays, each timed
    by CUDA events, divided by `calls`. No host time enters, unlike
    time_ms, where a call's host time shows wherever it exceeds the
    kernel's."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def attention_bound(shape, dtype):
    """Least time for the work: q, k, v read once, O written once, against
    QK^T and PV at the card's peak rate for the dtype."""
    n, t, h, d = shape
    esize = torch.finfo(dtype).bits // 8
    bytes_ms = 4 * n * t * h * d * esize / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * n * h * t * t * d / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def designs_of(shape, dtype, backward):
    """(the design `_plan` picks, every design that takes the shape): the
    tiled design takes every shape, the whole pair only what _plan gives
    it."""
    from vitpose_tpu_torch.ops.attention import _plan
    planned = _plan(shape[1], shape[3], dtype, backward)[0]
    return planned, ('tiled', 'pair') if planned == 'pair' else ('tiled',)


def time_designs(run, designs, timer=time_ms):
    """ms of run(design) for each design by `timer`. Two designs are timed
    in turns on this card (old, new, new, old) and each gets the mean of
    its two turns; returns ({design: ms}, [the four turns])."""
    if len(designs) == 1:
        return {designs[0]: timer(lambda: run(designs[0]))}, []
    old, new = designs
    turns = [(d, timer(lambda d=d: run(d))) for d in (old, new, new, old)]
    return {d: statistics.mean(ms for dd, ms in turns if dd == d)
            for d in designs}, turns


def design_note(planned, ms, turns, dev):
    """The part of a kernel line that names the designs and their times:
    back to back (kernel_ms; tiled_ms for the old design) and on the device
    alone (device_ms, CUDA graph)."""
    note = f'design {planned}, kernel_ms {ms[planned]:.4f}'
    if turns:
        note += f', tiled_ms {ms["tiled"]:.4f} (turns ' + ', '.join(
            f'{d} {t:.4f}' for d, t in turns) + ')'
    return note + ', device_ms ' + ', '.join(
        f'{d} {t:.4f}' for d, t in dev.items())


def phase_kernel():
    from vitpose_tpu_torch.ops import attention as attn
    torch.backends.cuda.matmul.allow_tf32 = False     # true f32 reference
    gen = torch.Generator(device='cuda').manual_seed(0)
    records = []
    for shape, dtype, role in KERNEL_CASES:
        n, t, h, d = shape
        # strided q/k/v views of one qkv tensor, as the ViT gives them
        qkv = torch.randn(n, t, 3, h, d, generator=gen, device='cuda',
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv.unbind(2)
        ref = attn.reference_attention(q, k, v)
        atol, rtol = TOLS[dtype]
        planned, designs = designs_of(shape, dtype, False)
        errs = {}
        for design in designs:
            before = attn.fused_attention.design_launches[design]
            out = attn.fused_attention(q, k, v, _design=design)
            torch.cuda.synchronize()
            check(attn.fused_attention.design_launches[design] == before + 1,
                  f'K1 {design} did not count its launch')
            diff = (out.float() - ref.float()).abs()
            errs[design] = diff.max().item()
            bad = (diff > atol + rtol * ref.float().abs()).sum().item()
            check(torch.isfinite(out).all().item(),
                  f'K1 {design} non-finite at {shape}')
            check(bad == 0, f'K1 {design} disagrees with plain at {shape} '
                  f'{dtype}: {bad} elements, max abs err {errs[design]}')
            del out, diff
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms, turns = time_designs(
            lambda dsg: attn.fused_attention(q, k, v, _design=dsg), designs)
        dev, _ = time_designs(
            lambda dsg: attn.fused_attention(q, k, v, _design=dsg), designs,
            device_ms)
        plain_ms = time_ms(lambda: attn.reference_attention(q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bound_ms, bound_by = attention_bound(shape, dtype)
        dt = str(dtype).replace('torch.', '')
        print(f'kernel attention_fwd {shape} {dt} ({role}): max_abs_err '
              + ', '.join(f'{dsg} {e:.3e}' for dsg, e in errs.items())
              + f' (tol {atol:g} + {rtol:g}|ref|), '
              f'{design_note(planned, ms, turns, dev)}, plain_ms {plain_ms:.4f}, '
              f'library_ms {lib_ms:.4f} (sdpa), bound_ms {bound_ms:.4f} '
              f'({bound_by})', flush=True)
        records.append(dict(shape=shape, dtype=dtype, design=planned,
                            err=errs[planned], ms=ms[planned],
                            old_ms=ms['tiled'] if turns else None,
                            device_ms=dev,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by))
        del qkv, q, k, v, ref
    print(f'kernels: attention_fwd built, launched and matched its plain '
          f'version at {len(records)} shapes, in every design that takes '
          f'each', flush=True)
    return records[0]


def shape_peaks(model):
    """Heatmaps with one smooth peak per joint at bright image patches."""
    bump = torch.tensor([1.0, 3.0, 3.0, 1.0])
    bump = torch.outer(bump, bump) / 8
    with torch.no_grad():
        proj = model.backbone.patch_embed.proj
        proj.weight[0] = 20.0 / proj.weight[0].numel()
        head = model.keypoint_head
        for i in (0, 3):
            head.deconv_layers[i].weight[0, 0] = bump
        head.final_layer.weight[:, 0] = 1.0


def scene(seed, boxes):
    """A dim random 480x640 image with a bright 24x24 square at each box
    centre."""
    img = np.random.RandomState(seed).randint(0, 60, (480, 640, 3), np.uint8)
    for x, y, w, h in boxes[:, :4]:
        cx, cy = int(x + w / 2), int(y + h / 2)
        img[cy - 12:cy + 12, cx - 12:cx + 12] = 255
    return img


def grid_boxes(rng, cols, rows):
    """Boxes on a grid, far enough apart that no padded crop holds a second
    square."""
    xs, ys = np.meshgrid(10 + 160 * np.arange(cols),
                         10 + 240 * np.arange(rows))
    n = xs.size
    return np.stack([xs.ravel() + rng.uniform(0, 20, n),
                     ys.ravel() + rng.uniform(0, 20, n),
                     rng.uniform(100, 130, n), rng.uniform(190, 215, n),
                     np.full(n, 0.9)], 1).astype(np.float32)


def padded_boxes(boxes, model):
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs
    iw, ih = model.image_size
    c, s = bbox_xywh2cs(boxes[:, :4], iw / ih, padding=model.padding)
    return c.numpy(), s.numpy() * 200.0


class DeviceAudit(TorchDispatchMode):
    """Records every tensor an op takes or returns that is not on CUDA."""

    def __init__(self):
        super().__init__()
        self.off_device = set()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        leaves = tree_flatten((args, kwargs, out))[0]
        for x in leaves:
            if isinstance(x, torch.Tensor) and x.device.type != 'cuda':
                self.off_device.add(f'{func} {x.device} {tuple(x.shape)}')
        return out


def reset_counts():
    """Every kernel wrapper's launch counts to 0, per design too, and the
    int8 product's (torch._int_mm) count."""
    from vitpose_tpu_torch.models.vit import int8_matmul
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    for fn in (fused_attention, fused_attention_bwd):
        fn.launches = 0
        fn.design_launches = dict.fromkeys(fn.design_launches, 0)
        fn.shapes.clear()
    int8_matmul.launches = 0


def check_shapes_held(path):
    """Fail unless every (shape, dtype) at which K1 and K2 launched since
    the last reset_counts() is one that the kernel and kernel-bwd phases
    hold against the plain versions (KERNEL_CASES, BWD_CASES)."""
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    for name, fn, cases in (('K1', fused_attention, KERNEL_CASES),
                            ('K2', fused_attention_bwd, BWD_CASES)):
        held = {(shape, dtype) for shape, dtype, _ in cases}
        missing = sorted(str(key) for key in fn.shapes if key not in held)
        check(not missing, f'{path}: {name} launched at {missing}, which '
              'no kernel phase holds against its plain version')


def phase_serve():
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs
    model = init_pose_model(SERVE_CFG, device='cuda')
    shape_peaks(model.model)
    check(all(p.is_cuda for p in model.model.parameters()),
          'a parameter is off the card')
    rng = np.random.RandomState(0)
    boxes = grid_boxes(rng, 4, 2)
    img = scene(0, boxes)
    persons = [{'bbox': b} for b in boxes]

    reset_counts()
    t0 = time.perf_counter()
    results, _ = inference_top_down_pose_model(model, img, persons)
    call_s = time.perf_counter() - t0
    launches = fused_attention.launches
    bwd_launches = fused_attention_bwd.launches
    depth = model.cfg.backbone.depth
    check(launches == depth * 2, f'K1 launched {launches} times in the '
          f'serve call, expected {depth} blocks x 2 passes')
    check(fused_attention.design_launches == {'pair': depth * 2, 'tiled': 0},
          f'K1 designs in the serve call: {fused_attention.design_launches}, '
          'expected the whole pair every time')
    check(bwd_launches == 0, f'K2 launched {bwd_launches} times in the '
          'serve call, expected none')

    kp = np.stack([r['keypoints'] for r in results])          # [8, 17, 3]
    check(kp.shape == (8, 17, 3) and np.isfinite(kp).all(),
          f'keypoints not finite or of shape {kp.shape}')
    center, size = padded_boxes(boxes, model)
    inside = np.abs(kp[..., :2] - center[:, None]) <= size[:, None] / 2
    check(inside.all(), f'{(~inside).sum()} keypoint coordinates outside '
          'their padded boxes')

    # warp to decode once more, recording every tensor that is not on CUDA
    dev = model.device
    iw, ih = model.image_size
    image = torch.from_numpy(img).to(dev)
    c, s = bbox_xywh2cs(boxes[:, :4], iw / ih)
    c, s = c.to(dev), s.to(dev)
    audit = DeviceAudit()
    with audit:
        model.infer_batch(image[None].expand(8, *image.shape), c, s)
    torch.cuda.synchronize()
    check(not audit.off_device, f'off-card tensors on the serving path: '
          f'{sorted(audit.off_device)[:5]}')
    print(f'serve: ViTPose-B 256x192 bf16, 8 boxes, {launches} K1 launches '
          f'(12 blocks x 2, all whole-pair) and {bwd_launches} K2, keypoints '
          f'finite and inside their padded boxes, '
          f'{audit.ops} ops all on CUDA, first call {call_s:.2f} s',
          flush=True)

    n = 256
    big = np.stack([rng.uniform(0, 480, n), rng.uniform(0, 260, n),
                    rng.uniform(60, 160, n), rng.uniform(120, 220, n)], 1)
    c, s = bbox_xywh2cs(big.astype(np.float32), iw / ih)
    c, s = c.to(dev), s.to(dev)
    imgs = image[None].expand(n, *image.shape)
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, _ = model.infer_batch(imgs, c, s)
        torch.cuda.synchronize()
        if i:                                            # first is warm-up
            times.append(time.perf_counter() - t0)
        check(torch.isfinite(preds).all().item(), 'non-finite batch preds')
    med = statistics.median(times)
    return model, launches, med, n / med


def phase_serve_ref():
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    boxes = grid_boxes(np.random.RandomState(1), 2, 1)
    img = scene(1, boxes)
    persons = [{'bbox': b} for b in boxes]
    out = {}
    for dtype in ('float32', 'bfloat16'):
        cfg = {'variant': 'b', 'dtype': dtype,
               'backbone_overrides': {'fused_attention': True}}
        for dev in ('cuda', 'cpu'):
            model = init_pose_model(cfg, device=dev)
            shape_peaks(model.model)
            res, hm = inference_top_down_pose_model(model, img, persons,
                                                    return_heatmap=True)
            out[dev, dtype] = (np.stack([r['keypoints'][:, :2] for r in res]),
                               hm[0]['heatmap'])
            del model
    kp_ref, hm_ref = out['cpu', 'float32']

    kp_g, hm_g = out['cuda', 'float32']
    atol, rtol = HM_TOL
    hm_err = np.abs(hm_g - hm_ref).max()
    check(np.all(np.abs(hm_g - hm_ref) <= atol + rtol * np.abs(hm_ref)),
          f'f32 CUDA and CPU heatmaps differ by {hm_err}')
    top2 = np.sort(hm_ref.reshape(*hm_ref.shape[:2], -1), axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 100 * atol
    check(decisive.mean() >= 0.5, f'only {decisive.sum()} decisive joints')

    def kp_err(kp):
        return np.abs(kp - kp_ref).max(-1)[decisive].max()

    check(kp_err(kp_g) <= KP_TOL_PX, f'f32 keypoints differ by '
          f'{kp_err(kp_g)} px')
    print(f'serve-ref: f32 (TF32 off) CUDA+K1 vs CPU plain, 2 boxes: heatmap '
          f'max abs diff {hm_err:.3e} (tol {atol:g} + {rtol:g}|ref|), '
          f'keypoints max diff {kp_err(kp_g):.3e} px (tol {KP_TOL_PX}) over '
          f'{decisive.sum()}/{decisive.size} decisive joints', flush=True)

    (kp_gb, hm_gb), (kp_cb, hm_cb) = out['cuda', 'bfloat16'], out['cpu',
                                                                'bfloat16']
    errs = {'heatmap': (np.abs(hm_gb - hm_ref).max(),
                        np.abs(hm_cb - hm_ref).max(), 0.0),
            'keypoint px': (kp_err(kp_gb), kp_err(kp_cb), KP_TOL_PX)}
    for what, (cuda_err, cpu_err, floor) in errs.items():
        check(cuda_err <= BF16_FACTOR * cpu_err + floor,
              f'bf16 CUDA {what}s are {cuda_err} from the f32 answer, the '
              f'bf16 CPU path {cpu_err}: more than {BF16_FACTOR}x + '
              f'{floor}')
    print(f'serve-ref: bf16 against the f32 CPU answer, 2 boxes: CUDA+K1 / '
          f'CPU plain heatmap max abs diff {errs["heatmap"][0]:.3e} / '
          f'{errs["heatmap"][1]:.3e}, decisive keypoints '
          f'{errs["keypoint px"][0]:.3e} / {errs["keypoint px"][1]:.3e} px '
          f'(CUDA at most {BF16_FACTOR}x CPU, + {KP_TOL_PX} px for '
          f'keypoints); CUDA vs CPU bf16 heatmaps '
          f'{np.abs(hm_gb - hm_cb).max():.3e}; max |f32 heatmap| '
          f'{np.abs(hm_ref).max():.3e}', flush=True)


# int8: the four ViT-B products (in, out) and the rows of one 8-box call's
# pass (checked against the CPU) and of a 256-crop batch's (timed)
INT8_SHAPES = (('qkv', 768, 2304), ('proj', 768, 768), ('fc1', 768, 3072),
               ('fc2', 3072, 768))
INT8_CHECK_ROWS = 8 * 192
INT8_TIME_ROWS = 256 * 192
INT8_PEAK_OPS = 1979e12              # dense int8 tensor-core rate


def int8_bound(m, k, n):
    """Least time of the int8 product: x_q and w_q read once, the int32
    output written once, against 2mnk operations at the int8 peak."""
    bytes_ms = (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * m * n * k / INT8_PEAK_OPS * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def phase_int8(card):
    """Int8Linear on the card against its CPU path at the four ViT-B
    shapes, bf16 in and out as the serve path runs it: equal weight and
    activation codes, an exact int32 product, equal outputs; then the
    times of torch._int_mm, the bf16 product it replaces, and the
    quantise + dequantise passes alone."""
    from vitpose_tpu_torch.models.vit import Int8Linear, int8_matmul
    gen = torch.Generator().manual_seed(3)
    records = {}
    for name, k, n in INT8_SHAPES:
        x = torch.randn(INT8_CHECK_ROWS, k, generator=gen).to(torch.bfloat16)
        a = float(x.float().abs().amax())
        cpu = Int8Linear(k, n, act_scale=a)
        with torch.no_grad():
            cpu.weight.copy_(torch.randn(n, k, generator=gen) * k ** -0.5)
            cpu.bias.copy_(0.1 * torch.randn(n, generator=gen))
        card_layer = Int8Linear(k, n, act_scale=a).cuda()
        card_layer.load_state_dict(cpu.state_dict())
        xc = x.cuda()
        w_q, _ = cpu.quantized_weight()
        w_qc, _ = card_layer.quantized_weight()
        x_q, _ = cpu.quantize_input(x)
        x_qc, _ = card_layer.quantize_input(xc)
        check(torch.equal(w_qc.cpu(), w_q) and torch.equal(x_qc.cpu(), x_q),
              f'int8 {name}: codes differ between the card and the CPU')
        y = int8_matmul(x_q, w_q)
        yc = int8_matmul(x_qc, w_qc)
        check(torch.equal(yc.cpu(), y), f'int8 {name}: the int32 product '
              'differs between the card and the CPU')
        with torch.no_grad():
            out = cpu(x, torch.bfloat16).float()
            outc = card_layer(xc, torch.bfloat16).float().cpu()
        err = (outc - out).abs().max().item()
        check(err == 0.0, f'int8 {name}: outputs differ by {err}')

        m = INT8_TIME_ROWS
        xt = torch.randn(m, k, device='cuda', dtype=torch.bfloat16)
        card_layer.act_scale = float(xt.float().abs().amax())
        w_qc, s_w = card_layer.quantized_weight()
        x_qt, s_x = card_layer.quantize_input(xt)
        yt = int8_matmul(x_qt, w_qc)
        w16, b16 = (t.detach().to(torch.bfloat16) for t in (
            card_layer.weight, card_layer.bias))
        bias = card_layer.bias.detach()

        def quant_dequant():
            card_layer.quantize_input(xt)
            ((yt.float() * s_x) * s_w + bias).to(torch.bfloat16)

        with torch.no_grad():
            ms = {'int_mm': time_ms(lambda: int8_matmul(x_qt, w_qc)),
                  'bf16': time_ms(lambda: F.linear(xt, w16, b16)),
                  'quant_dequant': time_ms(quant_dequant),
                  'int8_linear': time_ms(
                      lambda: card_layer(xt, torch.bfloat16))}
        bound_ms, bound_by = int8_bound(m, k, n)
        print(f'int8 {name} [{INT8_CHECK_ROWS}x{k}] x [{k}x{n}]: codes, '
              f'int32 product and bf16 outputs equal the CPU path\'s '
              f'(tol 0); at {m} rows: _int_mm {ms["int_mm"]:.4f} ms '
              f'(bound {bound_ms:.4f}, {bound_by}), bf16 matmul '
              f'{ms["bf16"]:.4f} ms, quantise + dequantise '
              f'{ms["quant_dequant"]:.4f} ms, Int8Linear '
              f'{ms["int8_linear"]:.4f} ms on {card}', flush=True)
        records[name] = dict(ms, bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=err)
        del xt, x_qt, yt
    torch.cuda.empty_cache()
    return records


def scene_crops(pm, img, boxes):
    """The normalised crops of `boxes` on `img`, as the serve path cuts
    them, on the card: representative calibration inputs for the shaped
    weights (the server's --calib-dir)."""
    from vitpose_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs, udp_warp_matrix
    from vitpose_tpu_torch.ops.warp import warp_affine_batch
    iw, ih = pm.image_size
    c, s = bbox_xywh2cs(boxes[:, :4], iw / ih, padding=pm.padding)
    n = len(boxes)
    x = (torch.from_numpy(img).cuda().float() / 255.0)[None].expand(
        n, -1, -1, -1)
    mat = udp_warp_matrix(torch.zeros(n, device='cuda'), c.cuda(), s.cuda(),
                          (iw, ih))
    crops = warp_affine_batch(x, mat, (iw, ih))
    return ((crops - torch.as_tensor(IMAGENET_MEAN, device='cuda'))
            / torch.as_tensor(IMAGENET_STD, device='cuda'))


FAST_CFG = {'variant': 'b', 'dtype': 'bfloat16',
            'backbone_overrides': {'fused_attention': True,
                                   'gelu_approx': True}}
# serve-int8: the int8 path's keypoints (qkv on, skip 0 and 1) may lie at
# most this far from the --fast bf16 path's, in image pixels. The first
# chip run read 0.076 px (skip 0) and 0.070 px (skip 1); the bound is about
# three times that, a twelfth of the eval set's GT jitter
SERVE_INT8_KP_PX = 0.25
INT8_TURN_CALLS = 4


def batch_ms(pm, imgs, c, s, calls=INT8_TURN_CALLS):
    """Median ms of `calls` 256-crop infer_batch calls after one warm-up."""
    times = []
    for i in range(calls + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, _ = pm.infer_batch(imgs, c, s)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        check(torch.isfinite(preds).all().item(), 'non-finite batch preds')
    return statistics.median(times)


def phase_serve_int8(card):
    """Full-width ViTPose-B 256x192 through int8_serving_config (W8A8 MLP,
    qkv and proj; bf16, K1, tanh GELU as --fast) at skip 0 and 1, scales
    calibrated on the scene's crops: launches per 8-box call, keypoints
    against the --fast bf16 path's, and the 256-crop batch of int8 and of
    --fast bf16 timed in turns (bf16, int8, int8, bf16)."""
    import dataclasses
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    from vitpose_tpu_torch.models.vit import int8_matmul
    from vitpose_tpu_torch.ops.attention import fused_attention
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs
    from vitpose_tpu_torch.utils.quantize import (calibrate_act_scales,
                                                  first_last_skip,
                                                  int8_serving_config,
                                                  rebuild)
    fast = init_pose_model(FAST_CFG, device='cuda')
    shape_peaks(fast.model)
    rng = np.random.RandomState(0)
    boxes = grid_boxes(rng, 4, 2)
    img = scene(0, boxes)
    persons = [{'bbox': b} for b in boxes]
    scales = calibrate_act_scales(fast.model, [scene_crops(fast, img, boxes)],
                                  attn=True)
    ref, _ = inference_top_down_pose_model(fast, img, persons)
    kp_ref = np.stack([r['keypoints'] for r in ref])
    center, size = padded_boxes(boxes, fast)
    int8_models, out = {}, {}
    depth = fast.cfg.backbone.depth
    for skip in (0, 1):
        cfg = int8_serving_config(fast.cfg, scales, qkv=True,
                                  skip_blocks=first_last_skip(depth, skip,
                                                              skip))
        pm = dataclasses.replace(fast, model=rebuild(fast.model, cfg),
                                 cfg=cfg)
        reset_counts()
        results, _ = inference_top_down_pose_model(pm, img, persons)
        k1, mm = fused_attention.launches, int8_matmul.launches
        check(k1 == 2 * depth and fused_attention.design_launches
              == {'pair': k1, 'tiled': 0}, f'serve-int8 skip {skip}: K1 '
              f'{fused_attention.design_launches}, expected 24 whole-pair')
        check(mm == 8 * (depth - 2 * skip), f'serve-int8 skip {skip}: '
              f'_int_mm launched {mm} times, expected 4 products x '
              f'{depth - 2 * skip} blocks x 2 passes')
        kp = np.stack([r['keypoints'] for r in results])
        check(kp.shape == (8, 17, 3) and np.isfinite(kp).all(),
              f'serve-int8 keypoints not finite or of shape {kp.shape}')
        inside = np.abs(kp[..., :2] - center[:, None]) <= size[:, None] / 2
        check(inside.all(), f'serve-int8: {(~inside).sum()} keypoint '
              'coordinates outside their padded boxes')
        dist = np.abs(kp[..., :2] - kp_ref[..., :2]).max(-1)
        out[skip] = dict(k1=k1, int_mm=mm, kp_px=float(dist.max()),
                         score=float(np.abs(kp[..., 2]
                                            - kp_ref[..., 2]).max()))
        print(f'serve-int8: ViTPose-B 256x192 int8 (qkv on, skip {skip}), '
              f'8 boxes: {k1} K1 launches (all whole-pair), {mm} _int_mm; '
              f'keypoints finite and inside their padded boxes, max '
              f'{dist.max():.4f} px (median {np.median(dist):.4f}; bound '
              f'{SERVE_INT8_KP_PX}) and score {out[skip]["score"]:.4f} from '
              f'the --fast bf16 path\'s', flush=True)
        check(dist.max() <= SERVE_INT8_KP_PX, f'serve-int8 skip {skip}: '
              f'keypoints {dist.max()} px from bf16, bound '
              f'{SERVE_INT8_KP_PX}')
        int8_models[skip] = pm
    n = 256
    big = np.stack([rng.uniform(0, 480, n), rng.uniform(0, 260, n),
                    rng.uniform(60, 160, n), rng.uniform(120, 220, n)], 1)
    iw, ih = fast.image_size
    c, s = (t.cuda() for t in bbox_xywh2cs(big.astype(np.float32), iw / ih))
    imgs = torch.from_numpy(img).cuda()[None].expand(n, -1, -1, -1)
    turns = [(name, batch_ms(pm, imgs, c, s)) for name, pm in (
        ('bf16', fast), ('int8', int8_models[0]), ('int8', int8_models[0]),
        ('bf16', fast))]
    ms = {name: statistics.mean(t for nn, t in turns if nn == name)
          for name in ('bf16', 'int8')}
    print(f'serve-int8: 256-crop batch (warp, ViT-B + K1, tanh GELU, flip '
          f'test, UDP decode) bf16 {ms["bf16"]:.1f} ms, int8 qkv skip 0 '
          f'{ms["int8"]:.1f} ms = {ms["int8"] / ms["bf16"]:.2f}x (turns ' +
          ', '.join(f'{nn} {t:.1f}' for nn, t in turns) + f') on {card}',
          flush=True)
    del fast, int8_models
    torch.cuda.empty_cache()
    return out, ms


DEPLOY_REQUESTS = 5                  # timed requests per mode and box count
DEPLOY_DIRECT_CALLS = 5              # timed direct API calls of the same


def phase_deploy(card, root):
    """tools/serve.py on the card, as a user starts it: the COCO-B config
    (bf16, K1) in its default mode, --fast and --int8-qkv (calibrated on
    the scene's person crops through --calib-dir), and the default
    --variant s with --fast (K1 at head dim 32), each from shaped weights
    saved as a .pth. Every response equals the direct API call on the
    server's model; K1 (and _int_mm) launches per request; p50/p99
    latency of 1-box and 8-box requests, beside the median of the direct
    call alone."""
    import base64
    import http.client
    import os
    import threading
    import cv2
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    from vitpose_tpu_torch.models.vit import int8_matmul
    from vitpose_tpu_torch.ops.attention import fused_attention
    from vitpose_tpu_torch.tools import serve
    rng = np.random.RandomState(2)
    boxes = grid_boxes(rng, 4, 2)
    img = scene(2, boxes)
    body = {n: json.dumps({'image': base64.b64encode(cv2.imencode(
        '.png', img[..., ::-1])[1].tobytes()).decode(),
        'bboxes': boxes[:n].tolist()}).encode() for n in (1, 8)}
    ckpts = {}
    for variant, cfg in (('b', COCO_B), ('s', 's')):
        pm = init_pose_model(cfg, device='cuda')
        shape_peaks(pm.model)
        ckpts[variant] = os.path.join(root, f'vitpose_{variant}_peaks.pth')
        torch.save(pm.model.state_dict(), ckpts[variant])
        del pm
    calib = os.path.join(root, 'calib')
    os.makedirs(calib)
    for i, (x, y, w, h, _) in enumerate(boxes.astype(int)):
        cv2.imwrite(os.path.join(calib, f'{i}.png'),
                    img[y:y + h, x:x + w, ::-1])
    modes = {
        'b default': ['--config', COCO_B, '--checkpoint', ckpts['b']],
        'b --fast': ['--config', COCO_B, '--checkpoint', ckpts['b'],
                     '--fast'],
        'b --int8-qkv': ['--config', COCO_B, '--checkpoint', ckpts['b'],
                         '--int8-qkv', '--calib-dir', calib],
        's --fast': ['--variant', 's', '--checkpoint', ckpts['s'], '--fast']}
    report = {}
    for mode, argv in modes.items():
        server = serve.build_server(argv + ['--port', '0', '--device',
                                            'cuda'])
        pm = server.pose_model
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]

        def post(n):
            conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
            try:
                conn.request('POST', '/predict', body=body[n],
                             headers={'Content-Type': 'application/json'})
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        try:
            lat, launches = {}, {}
            for n in (1, 8):
                status, got = post(n)
                check(status == 200, f'deploy {mode}: status {status} '
                      f'{got}')
                direct, _ = inference_top_down_pose_model(
                    pm, img, [{'bbox': b} for b in boxes[:n]])
                want = [{'bbox': np.asarray(r['bbox']).tolist(),
                         'keypoints': np.asarray(r['keypoints']).tolist()}
                        for r in direct]
                check(got['pose_results'] == want, f'deploy {mode}: the '
                      f'{n}-box response differs from the direct call')
                kp = np.array([r['keypoints'] for r in want])
                check(np.isfinite(kp).all(), f'deploy {mode}: non-finite '
                      'keypoints')
                reset_counts()
                times = []
                for _ in range(DEPLOY_REQUESTS):
                    t0 = time.perf_counter()
                    status, _ = post(n)
                    times.append((time.perf_counter() - t0) * 1e3)
                    check(status == 200, f'deploy {mode}: status {status}')
                launches[n] = (fused_attention.launches / DEPLOY_REQUESTS,
                               int8_matmul.launches / DEPLOY_REQUESTS)
                check(fused_attention.design_launches['tiled'] == 0,
                      f'deploy {mode}: K1 took the tiled design')
                # the same call without HTTP, base64, PNG and JSON
                direct_ms = []
                for _ in range(DEPLOY_DIRECT_CALLS):
                    t0 = time.perf_counter()
                    inference_top_down_pose_model(
                        pm, img, [{'bbox': b} for b in boxes[:n]])
                    direct_ms.append((time.perf_counter() - t0) * 1e3)
                lat[n] = (float(np.percentile(times, 50)),
                          float(np.percentile(times, 99)),
                          float(np.median(direct_ms)))
        finally:
            server.shutdown()
            server.server_close()
            thread.join(60)
        depth = pm.cfg.backbone.depth
        int8 = 'int8' in mode
        for n, (k1, mm) in launches.items():
            check(k1 == 2 * depth and mm == (8 * depth if int8 else 0),
                  f'deploy {mode}, {n} boxes: {k1} K1 and {mm} _int_mm per '
                  'request')
        report[mode] = dict(latency_ms=lat, k1_per_request=2 * depth,
                            int_mm_per_request=8 * depth if int8 else 0)
        print(f'deploy: tools/serve.py {mode}: responses equal the direct '
              f'call; {2 * depth} K1 launches (whole-pair) and '
              f'{8 * depth if int8 else 0} _int_mm per request; latency '
              f'p50/p99 over {DEPLOY_REQUESTS} requests (median direct API '
              f'call): 1 box {lat[1][0]:.1f}/{lat[1][1]:.1f} '
              f'({lat[1][2]:.1f}) ms, 8 boxes {lat[8][0]:.1f}/'
              f'{lat[8][1]:.1f} ({lat[8][2]:.1f}) ms on {card}', flush=True)
        del server, pm
        torch.cuda.empty_cache()
    return report


COCO_B = 'vitpose_tpu/configs/coco/vitpose_b_coco_256x192.py'
EVAL_BATCH = 64                      # the COCO-B config's batch size
EVAL_SMALL, EVAL_BIG = 26, 4         # 480x640 images, and 960x1280 ones
BOXES_PER_IMAGE = 4                  # 120 boxes: 1 full batch + 56
EVAL_REF_IMAGES = 4                  # eval-ref: their 16 boxes
GT_JITTER_PX = 3.0                   # GT joints: box centre + this sigma


def eval_scene(rng, boxes, scale):
    """A dim random (480, 640) * scale image with a bright square of
    24 * scale pixels at each box centre."""
    h, w, half = 480 * scale, 640 * scale, 12 * scale
    img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
    for x, y, bw, bh in boxes[:, :4]:
        cx, cy = int(x + bw / 2), int(y + bh / 2)
        img[cy - half:cy + half, cx - half:cx + half] = 255
    return img


def write_eval_set(root, seed, n_small=EVAL_SMALL, n_big=EVAL_BIG):
    """A synthetic COCO set in `root`: `n_small` 480x640 and `n_big`
    960x1280 JPEGs written with cv2, a person_keypoints json whose GT joints
    lie at each box centre (where `shape_peaks` puts the peak) plus
    GT_JITTER_PX of seeded jitter, one box in eight without a GT person, and
    a detection json of every box. The first EVAL_REF_IMAGES images also get
    a json pair of their own. Returns {name: path} and the number of
    boxes."""
    import os
    import cv2
    rng = np.random.RandomState(seed)
    images, anns, dets = [], [], []
    for i in range(n_small + n_big):
        scale = 2 if i >= n_small else 1
        boxes = grid_boxes(rng, 2, 2)
        boxes[:, 0] += rng.uniform(0, 300)
        boxes[:, :4] *= scale
        name = f'{i + 1:012d}.jpg'
        cv2.imwrite(os.path.join(root, name),
                    eval_scene(rng, boxes, scale)[..., ::-1])
        images.append(dict(id=i + 1, file_name=name, width=640 * scale,
                           height=480 * scale))
        for x, y, w, h, _ in boxes:
            dets.append(dict(image_id=i + 1, category_id=1,
                             bbox=[float(x), float(y), float(w), float(h)],
                             score=float(rng.uniform(0.5, 1.0))))
            if len(dets) % 8 == 0:
                continue                             # a false positive
            xy = np.array([x + w / 2, y + h / 2]) + rng.normal(
                0, GT_JITTER_PX * scale, (17, 2))
            v = np.where(rng.rand(17) < 0.9, 2, 0)
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=1,
                bbox=[float(x), float(y), float(w), float(h)],
                area=float(w * h), iscrowd=0,
                num_keypoints=int((v > 0).sum()),
                keypoints=np.concatenate([xy, v[:, None]], 1).ravel()
                .tolist()))
    cats = [dict(id=1, name='person')]
    files = {}
    ref_ids = set(range(1, EVAL_REF_IMAGES + 1))
    for tag, keep in (('', lambda a: True),
                      ('_ref', lambda a: a['image_id'] in ref_ids)):
        files['ann' + tag] = os.path.join(root, f'ann{tag}.json')
        files['det' + tag] = os.path.join(root, f'det{tag}.json')
        with open(files['ann' + tag], 'w') as f:
            json.dump(dict(images=[im for im in images
                                   if keep(dict(image_id=im['id']))],
                           annotations=[a for a in anns if keep(a)],
                           categories=cats), f)
        with open(files['det' + tag], 'w') as f:
            json.dump([d for d in dets if keep(d)], f)
    return files, len(dets)


def eval_options(root, files, tag=''):
    """--cfg-options that point the config's val set at the synthetic
    files, as a user points it at COCO."""
    return [f'data.val.ann_file={files["ann" + tag]}',
            f'data.val.img_prefix={root}/',
            f'data.val.bbox_file={files["det" + tag]}']


def eval_objects(options, checkpoint, device, batch_size=None,
                 config=None):
    """The CLI's model (checkpoint loaded, on `device`), dataset and loader
    for `config` (default: the COCO-B config) with `options`."""
    from vitpose_tpu_torch.api.inference import load_checkpoint
    from vitpose_tpu_torch.tools.test import build_eval_objects
    from vitpose_tpu_torch.utils.config import apply_options, load_config
    cfg = apply_options(load_config(config or COCO_B), options)
    model, ds, loader = build_eval_objects(cfg, batch_size)
    load_checkpoint(model, checkpoint)
    return model.to(device).eval(), ds, loader


def validate(model, loader):
    from vitpose_tpu_torch.eval.loop import run_validation
    c = model.cfg
    return run_validation(model, loader, use_udp=c.use_udp,
                          post_process=c.post_process,
                          modulate_kernel=c.modulate_kernel,
                          target_type=c.target_type)


def device_kernels(prof):
    """(name, start ns, end ns) of every device event of a torch.profiler
    run, less the ranges that annotate the device timeline
    (Optimizer.step#...), read from the profiler's raw results: parsing
    them into FunctionEvents (prof.events(), key_averages()) costs 4-5 s of
    host time per 15-20 thousand kernels on the card machine."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation() and not e.is_hidden_event()
                and not e.name().startswith('Optimizer.')):
            out.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return out


def busy_ms(events):
    """ms of the union of the events' device intervals: kernels that run at
    once (cuDNN may put a conv's parts on streams of its own) count once."""
    busy, end = 0, None
    for start, stop in sorted((e[1], e[2]) for e in events):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e6


def kernel_totals(events):
    """[(name, device ms, launches)] of device events, most time first."""
    totals = {}
    for name, start, stop in events:
        t = totals.setdefault(name, [0, 0])
        t[0] += stop - start
        t[1] += 1
    return sorted(((n, ns / 1e6, c) for n, (ns, c) in totals.items()),
                  key=lambda x: -x[1])


def device_busy_ms(run):
    """(the card's busy ms during one run(), by torch.profiler: the union of
    its device intervals, copies included; the profiled run's wall ms), or
    (None, wall) where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(device_kernels(prof))
    if busy == 0:
        return None, wall_ms
    check(busy <= wall_ms, f'profiler device time {busy:.1f} ms exceeds the '
          f'profiled run\'s wall time {wall_ms:.1f} ms')
    return busy, wall_ms


def phase_eval(card):
    import contextlib
    import io
    import os
    import tempfile
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.eval import COCO_KPT_STAT_NAMES
    from vitpose_tpu_torch.eval.loop import make_val_step
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.tools import test as cli
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        files, n_boxes = write_eval_set(root, 0)
        pm = init_pose_model(COCO_B, device='cuda')
        shape_peaks(pm.model)
        ckpt = os.path.join(root, 'vitpose_b_peaks.pth')
        torch.save(pm.model.state_dict(), ckpt)
        del pm
        print(f'eval: wrote {EVAL_SMALL + EVAL_BIG} JPEGs ({EVAL_BIG} of '
              f'960x1280, larger than the 640 canvas), {n_boxes} detection '
              f'boxes and the shaped weights in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        options = eval_options(root, files)
        n_batches = -(-n_boxes // EVAL_BATCH)

        # the main path: the CLI, as a user runs it on COCO val
        out_json = os.path.join(root, 'stats.json')
        reset_counts()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            stats = cli.main([COCO_B, ckpt, '--out', out_json,
                              '--cfg-options', *options])
        cli_s = time.perf_counter() - t0
        launches = fused_attention.launches
        bwd_launches = fused_attention_bwd.launches
        check(launches == 24 * n_batches, f'K1 launched {launches} times in '
              f'the eval run, expected 24 per batch x {n_batches}')
        check(fused_attention.design_launches == {'pair': launches,
                                                  'tiled': 0},
              f'K1 designs in the eval run: '
              f'{fused_attention.design_launches}, expected the whole pair')
        check(bwd_launches == 0, f'K2 launched {bwd_launches} times in the '
              'eval run, expected none')
        with open(out_json) as f:
            written = json.load(f)
        check(sorted(written) == sorted(COCO_KPT_STAT_NAMES)
              and written == {k: float(v) for k, v in stats.items()},
              f'the CLI wrote {written}, returned {dict(stats)}')
        check(json.loads(printed.getvalue()[printed.getvalue().index('{'):])
              == written, 'the CLI printed other stats than it wrote')
        check(0 < stats['AP'] < 1, f'AP {stats["AP"]} not in (0, 1)')
        print(f'eval: CLI (vitpose_tpu_torch.tools.test) on the COCO-B config '
              f'(ViTPose-B 256x192 bf16, flip test, UDP, batch {EVAL_BATCH}), '
              f'{n_boxes} boxes in {n_batches} batches: {launches} K1 '
              f'launches ({launches // n_batches} per batch, all whole-pair) '
              f'and {bwd_launches} K2; {cli_s:.1f} s with model build and '
              f'checkpoint load; stats ' + ', '.join(
                  f'{k} {v:.4f}' for k, v in stats.items()), flush=True)

        model, ds, loader = eval_objects(options, ckpt, 'cuda')
        decoder = ('native (csrc/loader.cpp)' if loader.use_native
                   else 'cv2')
        t0 = time.perf_counter()
        for batch in loader:
            pass
        host_s = time.perf_counter() - t0

        step = make_val_step(model, loader.image_size,
                             use_udp=model.cfg.use_udp,
                             post_process=model.cfg.post_process,
                             flip_index=ds.info.flip_index)
        args = [torch.from_numpy(np.ascontiguousarray(batch[k])).cuda()
                for k in ('imgs', 'center', 'scale', 'center_orig',
                          'scale_orig')]
        audit = DeviceAudit()
        with audit:
            step(*args)
        torch.cuda.synchronize()
        check(not audit.off_device, f'off-card tensors in the val step: '
              f'{sorted(audit.off_device)[:5]}')
        del args

        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = validate(model, loader)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ids = sorted(i for r in results for i in r['bbox_ids'])
        check(ids == list(range(n_boxes)), 'not one result per box')
        kp = np.concatenate([r['preds'] for r in results])
        check(kp.shape == (n_boxes, 17, 3) and np.isfinite(kp).all(),
              f'keypoints not finite or of shape {kp.shape}')
        rescored = ds.evaluate(results)
        drift = max(abs(rescored[k] - stats[k]) for k in stats)
        check(drift <= EVAL_REF_AP_TOL, f'the timed run scored stats '
              f'{drift} away from the CLI run')
        busy_ms, prof_ms = device_busy_ms(lambda: validate(model, loader))
        busy = ('not measured (the profiler saw no device time)'
                if busy_ms is None else
                f'{busy_ms:.1f} ms ({busy_ms / n_batches:.2f} per batch) of '
                f'the profiled run\'s {prof_ms:.1f} ms, idle share '
                f'{1 - busy_ms / prof_ms:.3f}')
        print(f'eval: decoder {decoder}, {loader.num_workers} threads; '
              f'{n_boxes} boxes through run_validation in {run_s * 1e3:.1f} '
              f'ms = {n_boxes / run_s:.1f} boxes/s (decode included), '
              f'{run_s * 1e3 / n_batches:.2f} ms per batch; the host alone '
              f'(decode + batch assembly, no model) {host_s * 1e3:.1f} ms = '
              f'{host_s * 1e3 / n_batches:.2f} ms per batch; card busy '
              f'{busy}; peak device memory {peak_gb:.2f} GB; every val-step '
              f'tensor on CUDA ({audit.ops} ops); on {card}', flush=True)
        del model, loader, results
        torch.cuda.empty_cache()
        phase_eval_ref(root, files, ckpt)
        int8 = phase_eval_int8(card, root, options, ckpt, stats, n_batches)
    return launches, int8


def phase_eval_int8(card, root, options, ckpt, bf16_stats, n_batches):
    """The evaluation CLI with --int8 --int8-skip 1 --show-dir on the same
    set and weights: K1 and _int_mm launches (calibration on the first two
    batches without the flip test, then W8A8 in blocks 1-10 of every
    batch), AP beside the bf16 run's, one drawing per val image."""
    import contextlib
    import io
    import os
    from vitpose_tpu_torch.models.vit import int8_matmul
    from vitpose_tpu_torch.ops.attention import fused_attention
    from vitpose_tpu_torch.tools import test as cli
    show_dir = os.path.join(root, 'show')
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        stats = cli.main([COCO_B, ckpt, '--int8', '--int8-skip', '1',
                          '--show-dir', show_dir, '--cfg-options',
                          *options])
    run_s = time.perf_counter() - t0
    k1, mm = fused_attention.launches, int8_matmul.launches
    check(k1 == 24 * n_batches + 2 * 12 and fused_attention.design_launches
          == {'pair': k1, 'tiled': 0}, f'eval --int8: K1 '
          f'{fused_attention.design_launches}, expected 24 per batch x '
          f'{n_batches} + 12 per calibration batch x 2, all whole-pair')
    check(mm == 8 * 10 * n_batches, f'eval --int8: _int_mm launched {mm} '
          f'times, expected 4 products x 10 blocks x 2 passes x '
          f'{n_batches} batches')
    check(0 < stats['AP'] < 1, f'int8 AP {stats["AP"]} not in (0, 1)')
    drawn = sorted(os.listdir(show_dir))
    check(len(drawn) == EVAL_SMALL + EVAL_BIG and drawn[0] == '000000000001'
          '.jpg', f'--show-dir wrote {len(drawn)} files, expected one per '
          f'val image ({EVAL_SMALL + EVAL_BIG})')
    print(f'eval: CLI --int8 --int8-skip 1 --show-dir on the same set: '
          f'{k1} K1 launches (24 per batch + 2 x 12 calibrating, all '
          f'whole-pair), {mm} _int_mm; AP {stats["AP"]:.4f} beside bf16 '
          f'{bf16_stats["AP"]:.4f} (difference '
          f'{stats["AP"] - bf16_stats["AP"]:+.4f}), AR {stats["AR"]:.4f} '
          f'beside {bf16_stats["AR"]:.4f}; {len(drawn)} drawings; '
          f'{run_s:.1f} s with calibration and drawing on {card}',
          flush=True)
    return dict(k1=k1, int_mm=mm, ap=stats['AP'], bf16_ap=bf16_stats['AP'])


# eval-ref, f32 CUDA (K1) against the f32 CPU port on the same 16 boxes:
# AP may differ by at most this much (the keypoints agree as serve-ref's do)
EVAL_REF_AP_TOL = 1e-3
# eval-ref, bf16 CUDA against the f32 CPU answer. The first chip run read
# 0.070 px between the two on the shaped peaks (and 3.05e-5 px for f32
# CUDA), and the same AP. The keypoint bound is 3.5x that spread, a
# twelfth of the GT jitter. AP on these boxes moves in steps of about
# 1 / (10 OKS thresholds x 14 GT persons) = 0.007 when one match changes,
# and 0.25 px moves an OKS by at most about 0.016 here (the steepest
# joint, sigma 0.025, on a 23,000 px^2 box at GT_JITTER_PX): the AP bound
# allows three such changes
EVAL_REF_BF16_KP_PX = 0.25
EVAL_REF_BF16_AP_TOL = 0.02


def phase_eval_ref(root, files, ckpt):
    from vitpose_tpu_torch.api.inference import PoseModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    options = eval_options(root, files, '_ref')
    out = {}
    for dtype, dev in (('float32', 'cpu'), ('float32', 'cuda'),
                       ('bfloat16', 'cuda')):
        model, ds, loader = eval_objects(
            options + [f'model.dtype={dtype}'], ckpt, dev,
            batch_size=BOXES_PER_IMAGE * EVAL_REF_IMAGES)
        results = validate(model, loader)
        check(len(results) == 1, 'eval-ref boxes span more than one batch')
        out[dtype, dev] = (results[0]['preds'][..., :2],
                           ds.evaluate(results)['AP'])
        if dev == 'cpu':
            # the f32 CPU heatmaps of the same crops pick the decisive joints
            batch = next(iter(loader))
            pm = PoseModel(model=model, cfg=model.cfg,
                           dataset_info=ds.info, image_size=loader.image_size,
                           heatmap_size=tuple(ds.heatmap_size),
                           device=torch.device('cpu'))
            hm = pm.infer_batch(*(torch.from_numpy(batch[k]) for k in
                                  ('imgs', 'center', 'scale')),
                                return_heatmap=True)[2].numpy()
        del model
    kp_ref, ap_ref = out['float32', 'cpu']
    top2 = np.sort(hm.reshape(*hm.shape[:2], -1), axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 100 * HM_TOL[0]
    check(decisive.mean() >= 0.5, f'only {decisive.sum()} decisive joints')
    kp_f32, ap_f32 = out['float32', 'cuda']
    kp_bf16, ap_bf16 = out['bfloat16', 'cuda']
    err = np.abs(kp_f32 - kp_ref).max(-1)
    err_bf16 = np.abs(kp_bf16 - kp_ref).max(-1)
    print(f'eval-ref: {len(kp_ref)} boxes, f32 (TF32 off) CUDA+K1 vs CPU '
          f'plain: keypoints max diff {err[decisive].max():.3e} px over '
          f'{decisive.sum()}/{decisive.size} decisive joints (tol '
          f'{KP_TOL_PX}), {err.max():.3e} px over all; AP CUDA '
          f'{ap_f32:.6f} / CPU {ap_ref:.6f} (tol {EVAL_REF_AP_TOL})', flush=True)
    print(f'eval-ref: bf16 CUDA+K1 against the f32 CPU answer: AP '
          f'{ap_bf16:.6f} beside f32 {ap_ref:.6f} (tol '
          f'{EVAL_REF_BF16_AP_TOL}), decisive keypoints max diff '
          f'{err_bf16[decisive].max():.3e} px (tol {EVAL_REF_BF16_KP_PX}), '
          f'{err_bf16.max():.3e} px over all', flush=True)
    check(err[decisive].max() <= KP_TOL_PX, f'f32 eval keypoints differ by '
          f'{err[decisive].max()} px')
    check(abs(ap_f32 - ap_ref) <= EVAL_REF_AP_TOL, f'f32 AP CUDA {ap_f32} '
          f'vs CPU {ap_ref}')
    check(err_bf16[decisive].max() <= EVAL_REF_BF16_KP_PX, f'bf16 eval '
          f'keypoints are {err_bf16[decisive].max()} px from the f32 answer')
    check(abs(ap_bf16 - ap_ref) <= EVAL_REF_BF16_AP_TOL, f'bf16 AP '
          f'{ap_bf16} vs f32 {ap_ref}')


def attention_bwd_bound(shape, dtype):
    """Least time for K2's work: q, k, v, g read once and dq, dk, dv written
    once, against the five [T, T] x d products at the card's peak rate."""
    n, t, h, d = shape
    esize = torch.finfo(dtype).bits // 8
    bytes_ms = 7 * n * t * h * d * esize / HBM_BYTES_PER_S * 1e3
    ops_ms = 10 * n * h * t * t * d / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def bwd_error(outs, refs, dtype):
    """Max abs error over (dq, dk, dv) and whether each is inside
    BWD_TOLS."""
    atol, rtol = BWD_TOLS[dtype]
    err, ok = 0.0, True
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        diff = (o - r).abs()
        err = max(err, diff.max().item())
        ok &= bool(torch.isfinite(o).all().item())
        ok &= bool((diff <= atol * r.abs().max() + rtol * r.abs()).all()
                   .item())
    return err, ok


def phase_kernel_bwd():
    from vitpose_tpu_torch.ops import attention as attn
    torch.backends.cuda.matmul.allow_tf32 = False     # true f32 reference
    gen = torch.Generator(device='cuda').manual_seed(1)
    records = []
    for shape, dtype, role in BWD_CASES:
        n, t, h, d = shape
        qkv = torch.randn(n, t, 3, h, d, generator=gen, device='cuda',
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv.unbind(2)
        g = torch.randn(n, t, h, d, generator=gen, device='cuda',
                        dtype=torch.float32).to(dtype)
        refs = attn.reference_attention_bwd(q, k, v, g)
        atol, rtol = BWD_TOLS[dtype]
        planned, designs = designs_of(shape, dtype, True)
        errs = {}
        for design in designs:
            before = attn.fused_attention_bwd.design_launches[design]
            outs = attn.fused_attention_bwd(q, k, v, g, _design=design)
            torch.cuda.synchronize()
            check(attn.fused_attention_bwd.design_launches[design]
                  == before + 1, f'K2 {design} did not count its launch')
            errs[design], ok = bwd_error(outs, refs, dtype)
            check(ok, f'K2 {design} disagrees with plain at {shape} {dtype}: '
                  f'max abs err {errs[design]}')
            del outs
        ms, turns = time_designs(
            lambda dsg: attn.fused_attention_bwd(q, k, v, g, _design=dsg),
            designs)
        dev, _ = time_designs(
            lambda dsg: attn.fused_attention_bwd(q, k, v, g, _design=dsg),
            designs, device_ms)
        plain_ms = time_ms(lambda: attn.reference_attention_bwd(q, k, v, g))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        gt = g.transpose(1, 2)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qt, kt, vt)
            torch.autograd.grad(o, (qt, kt, vt), gt)

        lib_ms = (time_ms(sdpa_fwd_bwd) - time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt)))
        bound_ms, bound_by = attention_bwd_bound(shape, dtype)
        dt = str(dtype).replace('torch.', '')
        print(f'kernel-bwd attention_bwd {shape} {dt} ({role}): max_abs_err '
              + ', '.join(f'{dsg} {e:.3e}' for dsg, e in errs.items())
              + f' (tol {atol:g} max|ref| + {rtol:g}|ref|), '
              f'{design_note(planned, ms, turns, dev)}, plain_ms {plain_ms:.4f}, '
              f'library_ms {lib_ms:.4f} (sdpa bwd = fwd+bwd - fwd), '
              f'bound_ms {bound_ms:.4f} ({bound_by})', flush=True)
        records.append(dict(shape=shape, dtype=dtype, design=planned,
                            err=errs[planned], ms=ms[planned],
                            old_ms=ms['tiled'] if turns else None,
                            device_ms=dev,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by))
        del qkv, q, k, v, g, refs, qt, kt, vt, gt

    # K3 at the training shape: gradients through `attention` on CUDA are
    # K2's, and the plain backward's within BWD_TOLS
    n, t, h, d = TRAIN_BATCH, 192, 12, 64
    qkv = torch.randn(n, t, 3, h, d, generator=gen, device='cuda').to(
        torch.bfloat16).requires_grad_()
    g = torch.randn(n, t, h, d, generator=gen, device='cuda').to(
        torch.bfloat16)
    f0, b0 = attn.fused_attention.launches, attn.fused_attention_bwd.launches
    attn.attention(*qkv.unbind(2)).backward(g)
    torch.cuda.synchronize()
    check((attn.fused_attention.launches - f0,
           attn.fused_attention_bwd.launches - b0) == (1, 1),
          'K3 did not launch K1 and K2 once each')
    refs = attn.reference_attention_bwd(*qkv.detach().unbind(2), g)
    err, ok = bwd_error(qkv.grad.unbind(2), refs, torch.bfloat16)
    check(ok, f'K3 gradients differ from the plain backward by {err}')
    with torch.no_grad():
        attn.attention(*qkv.unbind(2))
    check(attn.fused_attention_bwd.launches - b0 == 1,
          'K3 launched K2 under no_grad')
    print(f'kernel-bwd: attention_bwd built, launched and matched its plain '
          f'version at {len(records)} shapes; K3 on CUDA at {(n, t, h, d)} '
          f'bf16 (1 K1 + 1 K2 launch) gives the plain backward within '
          f'{err:.3e}', flush=True)
    return records[0]


# COCO template of a standing person, (x, y) as fractions of its box
TEMPLATE = np.array([
    [.50, .08], [.55, .06], [.45, .06], [.60, .08], [.40, .08],
    [.70, .22], [.30, .22], [.78, .38], [.22, .38], [.80, .52], [.20, .52],
    [.62, .55], [.38, .55], [.63, .75], [.37, .75], [.64, .95], [.36, .95]],
    np.float32)


def synthetic_records(seed, n):
    """`n` dim random CANVAS x CANVAS images, each with one person: 17
    jittered COCO joints painted as bright 9x9 squares (a colour per joint),
    some of them invisible and unpainted, and the record a top-down loader
    gives for it (joints_3d, joints_3d_visible, center, scale)."""
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 40, (n, CANVAS, CANVAS, 3)).astype(np.uint8)
    colours = rng.randint(120, 256, (17, 3))
    records = []
    for i in range(n):
        bh = rng.uniform(200, 480)
        bw = bh * rng.uniform(0.4, 0.6)
        x0 = rng.uniform(10, CANVAS - 10 - bw)
        y0 = rng.uniform(10, CANVAS - 10 - bh)
        joints = TEMPLATE * [bw, bh] + [x0, y0] \
            + rng.normal(0, 0.03 * bh, (17, 2))
        joints = np.clip(joints, 5, CANVAS - 6).astype(np.float32)
        vis = (rng.rand(17) > 0.15).astype(np.float32)
        for (x, y), c, v in zip(joints.astype(int), colours, vis):
            if v:
                imgs[i, y - 4:y + 5, x - 4:x + 5] = c
        c, s = bbox_xywh2cs(np.array([x0, y0, bw, bh], np.float32),
                            192 / 256)
        records.append({
            'joints_3d': np.concatenate([joints, np.zeros((17, 1),
                                                          np.float32)], 1),
            'joints_3d_visible': np.repeat(vis[:, None], 3, 1),
            'center': c.numpy(), 'scale': s.numpy()})
    return imgs, records


def train_inputs(seed, n, info, device):
    """Canvases and host augmentation draws (COCO's AugmentConfig: flip,
    half-body, scale, rotation) of `n` synthetic records, on `device`."""
    from vitpose_tpu_torch.data.pipeline import (AugmentConfig,
                                                 sample_augmentations)
    imgs, records = synthetic_records(seed, n)
    rng = np.random.RandomState(seed)
    aug = AugmentConfig()
    draws = [sample_augmentations(rng, r, info, CANVAS, aug, (192, 256))
             for r in records]
    cols = [torch.from_numpy(np.stack(x)).to(device) for x in zip(*draws)]
    return [torch.from_numpy(imgs).to(device)] + cols


def train_setup(cfg, device):
    """(train state, step, preprocess, inputs) of ViTPose-B on `device`
    with the COCO-B optimizer; weights from init_pose_model's seed."""
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.data.pipeline import make_preprocess_fn
    from vitpose_tpu_torch.train import (OptimConfig, create_train_state,
                                         layer_decay_adamw, make_train_step)
    pm = init_pose_model(cfg, device=device)
    ocfg = OptimConfig()
    state = create_train_state(
        pm.model, layer_decay_adamw(pm.model, ocfg, STEPS_PER_EPOCH),
        ocfg.grad_clip_norm)
    preprocess = make_preprocess_fn((192, 256), (48, 64), use_udp=True,
                                    sigma=2.0)
    return state, make_train_step(pm.model), preprocess, pm.dataset_info


def snapshot(model):
    """Every parameter and BN running statistic, cloned."""
    out = {n: p.detach().clone() for n, p in model.named_parameters()}
    out.update({n: b.clone() for n, b in model.named_buffers()
                if 'running' in n})
    return out


def phase_train():
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    state, step, preprocess, info = train_setup(SERVE_CFG, 'cuda')
    model = state.model
    check(model.cfg.backbone.drop_path_rate == 0.3, 'drop_path is not 0.3')
    inputs = train_inputs(0, TRAIN_BATCH, info, 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    before = snapshot(model)
    t0 = time.perf_counter()
    m = step(state, preprocess(*inputs), gen)                 # warm-up
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    reset_counts()
    audit = DeviceAudit()
    with audit:
        m = step(state, preprocess(*inputs), gen)
    torch.cuda.synchronize()
    launches = (fused_attention.launches, fused_attention_bwd.launches)
    check(launches == (12, 12), f'one step launched K1, K2 {launches} '
          'times, expected 12 blocks each')
    designs = (fused_attention.design_launches,
               fused_attention_bwd.design_launches)
    check(designs == ({'pair': 12, 'tiled': 0},) * 2, f'K1, K2 designs in '
          f'one step: {designs}, expected the whole pair every time')
    check(not audit.off_device, f'off-card tensors in the train step: '
          f'{sorted(audit.off_device)[:5]}')
    grads = [p.grad for p in model.parameters()]
    check(all(g is not None and torch.isfinite(g).all().item()
              for g in grads), 'a gradient is missing or not finite')

    reset_counts()
    times = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, preprocess(*inputs), gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        vals = {k: v.item() for k, v in m.items()}
        check(all(np.isfinite(x) for x in vals.values()),
              f'non-finite metrics {vals}')
        check(0.0 <= vals['acc_pose'] <= 1.0, f'acc_pose {vals}')
    check((fused_attention.launches, fused_attention_bwd.launches)
          == (12 * TIMED_STEPS, 12 * TIMED_STEPS),
          'timed steps did not launch K1 and K2 12 times each')
    med = statistics.median(times)
    print(f'train: step times {", ".join(f"{t * 1e3:.1f}" for t in times)} '
          f'ms', flush=True)
    busy_ms = profile_steps(lambda: step(state, preprocess(*inputs), gen),
                            med)
    after = snapshot(model)
    unchanged = [n for n in before if torch.equal(before[n], after[n])]
    check(not unchanged, f'unchanged after {state.step} steps: '
          f'{unchanged[:5]}')
    print(f'train: ViTPose-B 256x192 bf16, drop_path 0.3, batch '
          f'{TRAIN_BATCH}: {launches[0]} K1 + {launches[1]} K2 launches per '
          f'step (all whole-pair), {audit.ops} ops all on CUDA, gradients finite, every '
          f'parameter and BN statistic changed; last timed step: '
          f'heatmap_loss {vals["heatmap_loss"]:.6f}, grad_norm '
          f'{vals["grad_norm"]:.6f}, acc_pose {vals["acc_pose"]:.4f}; '
          f'first step {first_s:.2f} s', flush=True)
    return launches, med, TRAIN_BATCH / med, busy_ms


def profile_steps(run_step, step_s, steps=2, label='train'):
    """Device time of `steps` profiled steps by torch.profiler: the card's
    busy time per step (the union of the kernels' intervals), the idle
    share against the unprofiled median step time `step_s` (unclamped), and
    the kernels that take the most time. Fails if the busy time exceeds the
    profiled steps' own wall time, which only a miscount can give. Returns
    the busy ms per step, or None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = device_kernels(prof)
    busy = busy_ms(events) / steps
    if busy == 0:
        print(f'{label}: device time not measured (the profiler saw no '
              'CUDA kernels)', flush=True)
        return None
    top = kernel_totals(events)[:8]
    check(busy <= wall_ms, f'profiler busy time {busy:.3f} ms per step '
          f'exceeds the profiled steps\' wall time {wall_ms:.3f} ms')
    print(f'{label}: profiler, {steps} steps: kernels busy {busy:.1f} ms '
          f'per step of the {step_s * 1e3:.1f} ms median step, idle share '
          f'{1 - busy / (step_s * 1e3):.3f} (profiled steps: '
          f'{wall_ms:.1f} ms each); top kernels (ms '
          f'per step, launches per step): ' + '; '.join(
              f'{name[:70]} {ms / steps:.2f} {count // steps}'
              for name, ms, count in top), flush=True)
    return busy


def train_run(cfg, device, batch):
    """Two steps on `batch`: (metrics of step 1, gradients of step 1 after
    the clip, the 2-step change of every parameter and BN statistic), all
    on the CPU in f64. A float64 `cfg` runs with its weights in f64."""
    state, step, _, _ = train_setup(cfg, device)
    if cfg.get('dtype') == 'float64':
        state.model.double()          # the optimizer holds the same tensors
    batch = {k: v.to(device) for k, v in batch.items()}
    gen = torch.Generator(device=device).manual_seed(0)
    before = snapshot(state.model)
    m = step(state, batch, gen)
    metrics = {k: v.item() for k, v in m.items()}
    grads = {n: p.grad.double().cpu()
             for n, p in state.model.named_parameters()}
    step(state, batch, gen)
    after = snapshot(state.model)
    delta = {n: (after[n] - before[n]).double().cpu() for n in after}
    return metrics, grads, delta


def ref_distances(run, ref, noise_only=()):
    """Distances of a train_run from the reference run: relative |loss| and
    |grad_norm|; for the gradients and the 2-step change of the BN
    statistics the max over tensors of max|x - ref| / max|ref|; for the
    2-step change of the parameters the max over tensors of the RMS of
    x - ref over the RMS of ref; a statistic's change is measured against
    at least STAT_NOISE_FLOOR of the largest (a change that is nought in
    the reference would divide by its rounding). The `noise_only`
    parameters, whose
    gradient is nought but for rounding, are left out of the gradients' and
    the parameters' distances. Also returns that RMS ratio per parameter
    tensor."""
    (m, g, d), (mr, gr, dr) = run, ref
    rel = {k: abs(m[k] - mr[k]) / abs(mr[k])
           for k in ('heatmap_loss', 'grad_norm')}
    held = [n for n in gr if n not in noise_only]
    rel['grads'] = max(((g[n] - gr[n]).abs().max() / gr[n].abs().max())
                       .item() for n in held)
    params = {n: ((d[n] - dr[n]).norm() / dr[n].norm()).item() for n in held}
    rel['params'] = max(params.values())
    stats = [n for n in dr if n not in gr]
    floor = STAT_NOISE_FLOOR * max(dr[n].abs().max().item() for n in stats)
    rel['bn_stats'] = max(((d[n] - dr[n]).abs().max()
                           / max(dr[n].abs().max().item(), floor)).item()
                          for n in stats)
    return rel, params


# a BN statistic whose 2-step change in the reference run is below this
# share of the largest change is taken as that share in ref_distances: a
# change that is nought but for rounding (Lite-HRNet's statistics behind
# the fusion that the loss does not reach) read 1e9 divided by itself
STAT_NOISE_FLOOR = 1e-6


def worst(dist, k=3):
    return ', '.join(f'{n} {v:.3e}' for n, v in
                     sorted(dist.items(), key=lambda x: -x[1])[:k])


# train-ref f32, CUDA against the CPU, in the units of ref_distances:
# summation order through 12 blocks and a BN over 2 crops. Measured 0 /
# 1.5e-4 / 1.5e-4 / 1.5e-3 / 3.3e-7; the largest parameter distances are in
# the first blocks' attn.proj and mlp.fc2 weights, where the step-2 update
# m_hat / sqrt(v_hat) turns the gradients' 1.5e-4 into about ten times that
TRAIN_REF_TOL = {'heatmap_loss': 1e-4, 'grad_norm': 1e-3, 'grads': 1e-3,
                 'params': 3e-3, 'bn_stats': 1e-5}


def phase_train_ref():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vitpose_tpu_torch.data.dataset_info import DatasetInfo
    from vitpose_tpu_torch.data.pipeline import make_preprocess_fn
    inputs = train_inputs(1, 2, DatasetInfo.load('coco'), 'cpu')
    batch = make_preprocess_fn((192, 256), (48, 64))(*inputs)
    runs = {}
    for dtype in ('float32', 'bfloat16'):
        cfg = {'variant': 'b', 'dtype': dtype, 'backbone_overrides': {
            'fused_attention': True, 'drop_path_rate': 0.0}}
        for dev in ('cuda', 'cpu'):
            runs[dev, dtype] = train_run(cfg, dev, batch)
    ref = runs['cpu', 'float32']
    f32, f32_params = ref_distances(runs['cuda', 'float32'], ref)
    print('train-ref: f32 (TF32 off) CUDA+K1+K2 vs CPU plain, ViT-B full '
          'depth, batch 2, drop_path 0: ' + ', '.join(
              f'{k} {v:.3e} (tol {TRAIN_REF_TOL[k]:g})'
              for k, v in f32.items()) + '; loss '
          f'{ref[0]["heatmap_loss"]:.6f}, grad_norm '
          f'{ref[0]["grad_norm"]:.6f}; largest per-tensor parameter '
          f'distances: {worst(f32_params)}', flush=True)
    for k, tol in TRAIN_REF_TOL.items():
        check(f32[k] <= tol, f'train-ref f32: {k} differs by {f32[k]} '
              f'(tol {tol})')
    gpu, gpu_params = ref_distances(runs['cuda', 'bfloat16'], ref)
    cpu, cpu_params = ref_distances(runs['cpu', 'bfloat16'], ref)
    print('train-ref: bf16 against the f32 CPU answer, CUDA+K1+K2 / CPU '
          'plain: ' + ', '.join(f'{k} {gpu[k]:.3e} / {cpu[k]:.3e}'
                                for k in gpu)
          + f' (CUDA at most {BF16_FACTOR}x CPU, + 2^-8 for the scalars); '
          f'largest per-tensor parameter distances, CUDA: '
          f'{worst(gpu_params)}; CPU: {worst(cpu_params)}', flush=True)
    for k in gpu:
        # one bf16 step of a scalar as a floor for loss and grad_norm
        floor = 2.0 ** -8 if k in ('heatmap_loss', 'grad_norm') else 0.0
        check(gpu[k] <= BF16_FACTOR * cpu[k] + floor,
              f'train-ref bf16: CUDA {k} is {gpu[k]} from the f32 answer, '
              f'the bf16 CPU path {cpu[k]}')


# train-loop: the training CLI on the COCO-B config. The train set: 39
# 480x640 images and one 960x1280 image of 4 boxes, 140 GT persons, so 2
# steps of 64 per epoch (drop_last); the val set: 28 + 4 images, 128
# detection boxes, 2 batches of 64. The run starts from the shaped weights
# (`load_from`), so that AP is not 0 on the synthetic GT.
LOOP_TRAIN_IMAGES = (39, 1)
LOOP_STEPS_PER_EPOCH = 2
LOOP_VAL_IMAGES = (28, 4)
LOOP_EPOCHS = 2


def loop_options(root, files, ckpt):
    return [f'data.train.ann_file={files["train"]["ann"]}',
            f'data.train.img_prefix={root}/train/',
            f'data.val.ann_file={files["val"]["ann"]}',
            f'data.val.img_prefix={root}/val/',
            f'data.val.bbox_file={files["val"]["det"]}',
            f'load_from={ckpt}', f'optimizer.total_epochs={LOOP_EPOCHS}',
            'runtime.eval_interval=1', 'runtime.ckpt_interval=1',
            'runtime.log_interval=1']


def run_train_cli(args):
    """The training CLI in this process, its printed records kept out of
    the smoke's output; returns (final state, the log records)."""
    import contextlib
    import io
    import os
    from vitpose_tpu_torch.tools import train as train_cli
    work_dir = args[args.index('--work-dir') + 1]
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_cli.main(args)
    with open(os.path.join(work_dir, 'train.log.json')) as f:
        return state, [json.loads(line) for line in f]


def step_times(records):
    """Wall seconds of each logged step but an epoch's first: the runner
    logs (and so reads the metrics back) after every step here."""
    out = []
    for a, b in zip(records, records[1:]):
        if a['mode'] == b['mode'] == 'train' and a['epoch'] == b['epoch']:
            out.append(b['time'] - a['time'])
    return out


def check_launches(what, steps, val_batches):
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    want = (12 * steps + 24 * val_batches, 12 * steps)
    got = (fused_attention.launches, fused_attention_bwd.launches)
    check(got == want, f'{what}: K1, K2 launched {got} times, expected '
          f'{want} (12 + 12 per step of {steps}, 24 K1 per val batch of '
          f'{val_batches})')
    designs = (fused_attention.design_launches,
               fused_attention_bwd.design_launches)
    check(designs == ({'pair': want[0], 'tiled': 0},
                      {'pair': want[1], 'tiled': 0}),
          f'{what}: K1, K2 designs {designs}, expected the whole pair')
    return got


def phase_train_loop(card, busy_ms):
    """The training CLI on the COCO-B config, 2 epochs with an evaluation
    and a checkpoint after each; then train-resume on its work dir."""
    import os
    import tempfile
    from vitpose_tpu_torch.api import init_pose_model
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        files = {}
        for name, (small, big), seed in (('train', LOOP_TRAIN_IMAGES, 1),
                                         ('val', LOOP_VAL_IMAGES, 2)):
            os.makedirs(os.path.join(root, name))
            files[name] = write_eval_set(os.path.join(root, name), seed,
                                         small, big)[0]
        pm = init_pose_model(COCO_B, device='cuda')
        shape_peaks(pm.model)
        ckpt = os.path.join(root, 'vitpose_b_peaks.pth')
        torch.save(pm.model.state_dict(), ckpt)
        del pm
        print(f'train-loop: wrote the synthetic train and val sets and the '
              f'shaped weights in {time.perf_counter() - t0:.1f} s',
              flush=True)
        work_dir = os.path.join(root, 'work')
        options = loop_options(root, files, ckpt)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, log = run_train_cli([COCO_B, '--work-dir', work_dir,
                                    '--cfg-options', *options])
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        train = [r for r in log if r['mode'] == 'train']
        epochs = [r for r in log if r['mode'] == 'epoch']
        steps = len(train)
        per_epoch = steps // LOOP_EPOCHS
        check(state.step == steps == LOOP_EPOCHS * per_epoch
              == LOOP_EPOCHS * LOOP_STEPS_PER_EPOCH,
              f'{steps} logged steps, state at step {state.step}, expected '
              f'{LOOP_EPOCHS} epochs of {LOOP_STEPS_PER_EPOCH}')
        check(all(np.isfinite(r[k]) for r in train
                  for k in ('heatmap_loss', 'grad_norm', 'acc_pose')),
              'a non-finite training metric')
        val_batches = -(-(LOOP_VAL_IMAGES[0] + LOOP_VAL_IMAGES[1]) * 4
                        // EVAL_BATCH)
        launches = check_launches('train-loop', steps,
                                  val_batches * LOOP_EPOCHS)
        ckpts = os.path.join(work_dir, 'ckpts')
        check(os.path.exists(os.path.join(ckpts, 'best.pth')),
              'no best.pth in the work dir')
        check(len(epochs) == LOOP_EPOCHS and all(
            0 <= r['AP'] <= 1 for r in epochs), f'epoch records {epochs}')
        times = step_times(log)
        med = statistics.median(times)
        last = train[-1]
        share = last['data_time'] / last['time']
        idle = ('not measured' if busy_ms is None
                else f'{1 - busy_ms / (med * 1e3):.3f}')
        ckpt_bytes = os.path.getsize(os.path.join(ckpts, 'epoch_0.pth'))
        print(f'train-loop: CLI (vitpose_tpu_torch.tools.train) on the COCO-B '
              f'config, batch {TRAIN_BATCH}, {LOOP_EPOCHS} epochs of '
              f'{per_epoch} steps ({steps} steps) from the shaped weights '
              f'(load_from), logging every step: {launches[0]} K1 + '
              f'{launches[1]} K2 launches (12 + 12 per step, 24 K1 per val '
              f'batch x {val_batches} x {LOOP_EPOCHS}, all whole-pair); '
              f'step wall time median {med * 1e3:.1f} ms '
              f'({min(times) * 1e3:.1f}-{max(times) * 1e3:.1f}) = '
              f'{TRAIN_BATCH / med:.1f} img/s; data_time share of epoch 1 '
              f'{share:.3f} ({last["data_time"]:.2f} of {last["time"]:.2f} '
              f's); card idle share {idle} (the train phase\'s kernel time '
              f'per step over this median); AP per epoch ' + ', '.join(
                  f'{r["AP"]:.4f}' for r in epochs) + f'; epoch times '
              + ', '.join(f'{r["epoch_time"]:.2f} s' for r in epochs)
              + f'; last heatmap_loss {last["heatmap_loss"]:.6f}; '
              f'checkpoint {ckpt_bytes / 1e9:.3f} GB per epoch; whole run '
              f'{run_s:.1f} s; peak device memory {peak_gb:.2f} GB; on '
              f'{card}', flush=True)
        del state
        torch.cuda.empty_cache()
        phase_train_resume(root, work_dir, options, log, card)
    return launches, steps, val_batches * LOOP_EPOCHS


def phase_train_resume(root, work_dir, options, log, card):
    """Restore the epoch-0 checkpoint into a fresh runner state bit for bit;
    redo epoch 1 with --resume in a copy of the work dir and hold it to the
    uninterrupted epoch exactly (the step is deterministic on the card);
    score best.pth with the evaluation CLI."""
    import contextlib
    import io
    import os
    import shutil
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.tools import test as test_cli
    from vitpose_tpu_torch.train.loop import build_train_state
    from vitpose_tpu_torch.utils.checkpoint import CheckpointManager
    from vitpose_tpu_torch.utils.config import apply_options, load_config
    ckpts = os.path.join(work_dir, 'ckpts')
    saved = torch.load(os.path.join(ckpts, 'epoch_0.pth'),
                       map_location='cpu', weights_only=True)
    cfg = apply_options(load_config(COCO_B), options)
    per_epoch = saved['step']
    state = build_train_state(cfg, per_epoch, 'cuda')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, epoch = CheckpointManager(ckpts).restore(state, 0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(epoch == 0 and state.step == saved['step'], 'restored step')
    for k, v in state.model.state_dict().items():
        check(v.is_cuda and torch.equal(v.cpu(), saved['model'][k]),
              f'restored {k} differs from the saved one')
    opt = state.optimizer.state_dict()
    check(opt['param_groups'] == saved['optimizer']['param_groups'],
          'restored optimizer groups (lr, decay) differ')
    n_moments = 0
    for i, st in opt['state'].items():
        for k, v in st.items():
            check(v.is_cuda and torch.equal(v.cpu(),
                                            saved['optimizer']['state'][i][k]),
                  f'restored AdamW {k} of parameter {i} differs or is off '
                  'the card')
            n_moments += 1
    check(state.scheduler.state_dict() == saved['scheduler'],
          'restored schedule differs')
    resave = os.path.join(root, 'resave')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CheckpointManager(resave).save(0, state)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(resave, 'epoch_0.pth'))
    del state
    torch.cuda.empty_cache()
    print(f'train-resume: the epoch-0 checkpoint restored into a fresh '
          f'runner state bit for bit (parameters, BN statistics, '
          f'{n_moments} AdamW tensors on the card, groups and lr, schedule, '
          f'step {saved["step"]}) in {restore_s:.2f} s; saving it took '
          f'{save_s:.2f} s for {nbytes / 1e9:.3f} GB', flush=True)

    copy = os.path.join(root, 'resumed')
    shutil.copytree(work_dir, copy)
    os.remove(os.path.join(copy, 'ckpts', 'epoch_1.pth'))
    os.remove(os.path.join(copy, 'ckpts', 'info_1.json'))
    reset_counts()
    t0 = time.perf_counter()
    _, relog = run_train_cli([COCO_B, '--work-dir', copy, '--resume',
                              '--cfg-options', *options])
    resume_s = time.perf_counter() - t0
    new = relog[len(log):]
    check(new[0] == {'mode': 'resume', 'epoch': 1}, f'resume record {new[0]}')
    got = [(r['step'], r['heatmap_loss']) for r in new
           if r['mode'] == 'train']
    want = [(r['step'], r['heatmap_loss']) for r in log
            if r['mode'] == 'train' and r['epoch'] == 1]
    val_batches = -(-(LOOP_VAL_IMAGES[0] + LOOP_VAL_IMAGES[1]) * 4
                    // EVAL_BATCH)
    check_launches('train-resume', len(got), val_batches)
    check(got == want, f'resumed epoch 1 losses {got[:3]}... differ from '
          f'the uninterrupted {want[:3]}...')
    a = torch.load(os.path.join(copy, 'ckpts', 'epoch_1.pth'),
                   map_location='cpu', weights_only=True)
    b = torch.load(os.path.join(work_dir, 'ckpts', 'epoch_1.pth'),
                   map_location='cpu', weights_only=True)
    differ = [k for k in b['model'] if not torch.equal(a['model'][k],
                                                       b['model'][k])]
    check(not differ, f'final weights differ from the uninterrupted run: '
          f'{differ[:5]}')
    ap_resumed = [r['AP'] for r in new if r['mode'] == 'epoch']
    ap_ref = [r['AP'] for r in log if r['mode'] == 'epoch'][1:]
    check(ap_resumed == ap_ref, f'resumed AP {ap_resumed} vs {ap_ref}')

    with open(os.path.join(work_dir, 'ckpts', 'meta.json')) as f:
        meta = json.load(f)
    best = os.path.join(work_dir, 'ckpts', 'best.pth')
    init_pose_model(COCO_B, checkpoint=best, device='cuda')
    val = [o for o in options if o.startswith('data.val.')]
    with contextlib.redirect_stdout(io.StringIO()):
        stats = test_cli.main([COCO_B, best, '--cfg-options', *val])
    check(stats['AP'] == meta['best_value'], f'the evaluation CLI scores '
          f'best.pth {stats["AP"]}, the runner logged {meta["best_value"]}')
    print(f'train-resume: epoch 1 redone with --resume (epoch-1 checkpoint '
          f'removed in a copy of the work dir) in {resume_s:.1f} s: '
          f'{len(got)} steps with the uninterrupted heatmap_loss exactly, '
          f'final weights and AP equal bit for bit (bound: exact; the step '
          f'is deterministic on the card); best.pth (epoch '
          f'{meta["best_epoch"]}) loads through init_pose_model and the '
          f'evaluation CLI scores it AP {stats["AP"]:.6f}, the AP the '
          f'runner logged; on {card}', flush=True)


REMAT_POLICIES = ('none', 'full', 'attn', 'dots')
REMAT_K1 = {'none': 12, 'full': 24, 'attn': 12, 'dots': 24}
REMAT_STEPS = 1                      # timed steps per turn, two turns each
# remat against no remat, in the units of ref_distances' 'grads': one bf16
# rounding step (2^-8 of a value). A recompute runs the same kernels on the
# same inputs: every policy read 0 on an H100 80GB HBM3 at 700 W.
REMAT_GRAD_TOL = 2.0 ** -8


def phase_remat(card):
    """ViTPose-B bf16 train steps at batch 64 in each remat policy, each
    from the same weights, batch and DropPath seed: K1 and K2 launches and
    gradients of the first step against no remat; the second step's peak
    memory above the resident weights and optimizer state; step times in
    turns (none, full, attn, dots, then back), all four states resident."""
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    batch, runs, grads, launches, extra = None, {}, {}, {}, {}
    gen = torch.Generator(device='cuda')
    for policy in REMAT_POLICIES:
        cfg = dict(SERVE_CFG)
        if policy != 'none':
            cfg.update(remat=True, remat_policy=policy)
        state, step, preprocess, info = train_setup(cfg, 'cuda')
        if batch is None:
            batch = preprocess(*train_inputs(0, TRAIN_BATCH, info, 'cuda'))
        reset_counts()
        step(state, batch, gen.manual_seed(0))
        torch.cuda.synchronize()
        launches[policy] = (fused_attention.launches,
                            fused_attention_bwd.launches)
        check(launches[policy] == (REMAT_K1[policy], 12), f'remat {policy}: '
              f'K1, K2 launched {launches[policy]} times in one step, '
              f'expected ({REMAT_K1[policy]}, 12)')
        grads[policy] = {n: p.grad.float().clone()
                         for n, p in state.model.named_parameters()}
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch, gen.manual_seed(1))
        torch.cuda.synchronize()
        extra[policy] = (torch.cuda.max_memory_allocated() - resident) / 1e9
        runs[policy] = (state, step)
    ref = grads['none']
    dist = {p: max(((grads[p][n] - ref[n]).abs().max()
                    / ref[n].abs().max()).item() for n in ref)
            for p in REMAT_POLICIES[1:]}
    del grads
    times = {p: [] for p in REMAT_POLICIES}
    for policy in REMAT_POLICIES + REMAT_POLICIES[::-1]:
        state, step = runs[policy]
        for i in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch, gen.manual_seed(i + 2))
            torch.cuda.synchronize()
            times[policy].append(time.perf_counter() - t0)
    del runs
    torch.cuda.empty_cache()
    med = {p: statistics.median(t) for p, t in times.items()}
    print('remat: ViTPose-B 256x192 bf16, batch 64, drop_path 0.3, the same '
          'weights, batch and DropPath seeds: ' + '; '.join(
              f'{p}: K1 {launches[p][0]} + K2 {launches[p][1]}, step '
              f'{med[p] * 1e3:.1f} ms (median of {len(times[p])} in two '
              f'turns, {min(times[p]) * 1e3:.1f}-'
              f'{max(times[p]) * 1e3:.1f}), peak {extra[p]:.2f} GB above '
              f'the resident state' + ('' if p == 'none' else
                                       f', grads {dist[p]:.3e} from no remat')
              for p in REMAT_POLICIES) + f' (tol {REMAT_GRAD_TOL:.3e}); on '
          f'{card}', flush=True)
    for p, d in dist.items():
        check(d <= REMAT_GRAD_TOL, f'remat {p}: gradients {d} from no remat')
    return {p: launches[p][0] for p in REMAT_POLICIES}


# moe-train: ViTPose+-B on six seeded synthetic train sets, each in its own
# dataset's format, sharing one folder of 480x640 JPEGs with four persons
# each (COCO and COCO-WholeBody share COCO's images in the real config too):
# 40 images, so 160 persons per set and 1 batch of 128 (the loader drops
# the ragged rest), 6 steps per epoch (the real mixture has some 9,000).
# The val set is COCO-format, 128 detection boxes: 1 batch of 128.
PLUS_B = 'vitpose_tpu/configs/coco/vitpose_plus_b_6datasets_256x192.py'
MOE_BATCH = 128                      # the ViTPose+-B config's batch size
MOE_SETS = (('coco', 17), ('aic', 14), ('mpii', 16), ('ap10k', 17),
            ('ap10k', 17), ('coco_wholebody', 17))       # the config's order
MOE_PARTS = (('foot_kpts', 6), ('face_kpts', 68), ('lefthand_kpts', 21),
             ('righthand_kpts', 21))
MOE_IMAGES = 40                      # 160 persons a set: 1 step of 128
MOE_STEPS_PER_SET = 1
MOE_VAL_IMAGES = (28, 4)             # 128 boxes: 1 batch of 128
MOE_AP_TOL = 0.002                   # split checkpoint vs the runner's AP
MOE_FEATURE_TOL = 2.0 ** -8          # one bf16 step of the largest output


def moe_joints(rng, box, k):
    """`k` joints spread over a person box, about 85% of them visible."""
    x, y, w, h = box
    xy = np.stack([rng.uniform(x + 0.1 * w, x + 0.9 * w, k),
                   rng.uniform(y + 0.05 * h, y + 0.95 * h, k)], 1)
    v = np.where(rng.rand(k) < 0.85, 2, 0)
    return np.concatenate([xy, v[:, None]], 1)


def write_moe_sets(root, seed):
    """The six train sets of the ViTPose+ config in `root`: COCO-format
    jsons for COCO, AIC, AP-10K and APT-36K, COCO-WholeBody's with its
    foot, face and hand fields, and MPII's list json (1-based center,
    scale, joints, joints_vis). Returns the config's `data.train` list."""
    import os
    import cv2
    rng = np.random.RandomState(seed)
    images, boxes = [], []
    for i in range(MOE_IMAGES):
        b = grid_boxes(rng, 2, 2)
        b[:, 0] += rng.uniform(0, 300)
        name = f'{i + 1:012d}.jpg'
        cv2.imwrite(os.path.join(root, name),
                    eval_scene(rng, b, 1)[..., ::-1])
        images.append(dict(id=i + 1, file_name=name, width=640, height=480))
        boxes += [(i + 1, name, [float(v) for v in box[:4]]) for box in b]
    train = []
    for idx, (name, k) in enumerate(MOE_SETS):
        ann = os.path.join(root, f'train_{idx}.json')
        if name == 'mpii':
            recs = []
            for _, file, (x, y, w, h) in boxes:
                kp = moe_joints(rng, (x, y, w, h), k)
                recs.append(dict(image=file, joints=(kp[:, :2] + 1).tolist(),
                                 joints_vis=(kp[:, 2] > 0).astype(int)
                                 .tolist(),
                                 center=[x + w / 2 + 1, y + h / 2 + 1],
                                 scale=h / 200.0))
            data = recs
        else:
            anns = []
            for image_id, _, box in boxes:
                kp = moe_joints(rng, box, k)
                a = dict(id=len(anns) + 1, image_id=image_id, category_id=1,
                         bbox=box, area=box[2] * box[3], iscrowd=0,
                         num_keypoints=int((kp[:, 2] > 0).sum()),
                         keypoints=kp.ravel().tolist())
                if name == 'coco_wholebody':
                    for field, n in MOE_PARTS:
                        a[field] = moe_joints(rng, box, n).ravel().tolist()
                anns.append(a)
            data = dict(images=images, annotations=anns,
                        categories=[dict(id=1, name='person')])
        with open(ann, 'w') as f:
            json.dump(data, f)
        train.append(dict(dataset=name, dataset_idx=idx, ann_file=ann,
                          img_prefix=f'{root}/'))
    return train


def moe_step_profile(cfg, step_s, card):
    """The kernel time of a ViTPose+-B step: a runner's train state for
    `cfg` on the card, one COCO and one WholeBody batch of the synthetic
    sets through the MoE step, then one step under torch.profiler."""
    from vitpose_tpu_torch.eval.loop import PinnedStaging
    from vitpose_tpu_torch.train.loop import (_batch_to_device, _train_data,
                                              build_train_state)
    from vitpose_tpu_torch.train.step import make_moe_train_step
    loader, preprocess, n = _train_data(cfg, 0)
    state = build_train_state(cfg, len(loader), 'cuda')
    step = make_moe_train_step(state.model, n)
    batches, staging = [], PinnedStaging()
    for child in (loader.loaders[0], loader.loaders[-1]):
        b = next(iter(child))
        pre = preprocess(*_batch_to_device(b, torch.device('cuda'), staging))
        pre['dataset_idx'] = b['dataset_idx']
        batches.append(pre)
    gen = torch.Generator(device='cuda').manual_seed(0)
    turn = [0]

    def run_step():
        step(state, batches[turn[0] % 2], gen)
        turn[0] += 1
    for _ in range(2):
        run_step()
    busy_ms = profile_steps(run_step, step_s, steps=1, label='moe-train')
    del state, batches
    torch.cuda.empty_cache()
    return busy_ms


def phase_moe_train(card):
    """ViTPose+-B multi-dataset MoE training through the training CLI on the
    shipped config, one epoch of 6 steps on six synthetic train sets, with
    `pretrained` the shaped dense ViT-B backbone (so its fc2 is split into
    the experts) and the shaped classic head by `load_from`; then
    model_split of its best.pth and the evaluation CLI on the COCO part
    with the plain COCO-B config."""
    import contextlib
    import io
    import os
    import tempfile
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.tools import test as test_cli
    from vitpose_tpu_torch.train.loop import (build_model_from_cfg,
                                              load_pretrained)
    from vitpose_tpu_torch.utils.config import apply_options, load_config
    times = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(root, 'train'))
        os.makedirs(os.path.join(root, 'val'))
        train = write_moe_sets(os.path.join(root, 'train'), 3)
        val = write_eval_set(os.path.join(root, 'val'), 4,
                             *MOE_VAL_IMAGES)[0]
        val_options = eval_options(os.path.join(root, 'val'), val)
        dense = init_pose_model(COCO_B, device='cuda')
        shape_peaks(dense.model)
        sd = dense.model.state_dict()
        pretrained = os.path.join(root, 'vitpose_b_backbone.pth')
        torch.save({'state_dict': {k[len('backbone.'):]: v.cpu()
                                   for k, v in sd.items()
                                   if k.startswith('backbone.')}},
                   pretrained)
        head = os.path.join(root, 'vitpose_b_head.pth')
        torch.save({k: v.cpu() for k, v in sd.items()
                    if k.startswith('keypoint_head.')}, head)
        # the ViTPose+ configs leave the fused attention off, as JAX's do;
        # the COCO-B config turns it on in its file, this run on the
        # command line
        options = [f'data.train={train!r}', *val_options,
                   'model.backbone_overrides.fused_attention=True',
                   f'pretrained={pretrained}', f'load_from={head}',
                   'optimizer.total_epochs=1', 'runtime.eval_interval=1',
                   'runtime.ckpt_interval=1', 'runtime.log_interval=1']
        cfg = apply_options(load_config(PLUS_B), options)
        times['data'] = time.perf_counter() - t0

        # the split `pretrained`: every expert's features are the dense
        # backbone's, before any step
        t0 = time.perf_counter()
        moe = build_model_from_cfg(cfg['model'])
        load_pretrained(moe, pretrained)
        moe = moe.to('cuda').eval()
        bb = moe.cfg.backbone
        check((bb.num_experts, bb.part_dim, bb.embed_dim, bb.depth,
               bb.dtype) == (6, 192, 768, 12, 'bfloat16'),
              f'the ViTPose+-B config built {bb}')
        x = torch.randn(8, 256, 192, 3, device='cuda',
                        generator=torch.Generator('cuda').manual_seed(5))
        with torch.inference_mode():
            want = dense.model.backbone(x).float()
            dist = [((moe.backbone(x, expert_idx=e).float() - want).abs()
                     .max() / want.abs().max()).item()
                    for e in range(bb.num_experts)]
        n_params = sum(p.numel() for p in moe.parameters())
        del moe, dense, sd
        torch.cuda.empty_cache()
        times['features'] = time.perf_counter() - t0
        check(max(dist) <= MOE_FEATURE_TOL, f'moe-train: the split '
              f'experts\' features differ from the dense backbone\'s by '
              f'{dist} of its largest value (tol {MOE_FEATURE_TOL})')
        print(f'moe-train: pretrained (the shaped dense ViT-B backbone) '
              f'split into {bb.num_experts} experts of part_dim '
              f'{bb.part_dim}: every expert\'s bf16 features on the card '
              f'equal the dense backbone\'s within ' + ', '.join(
                  f'{d:.3e}' for d in dist) + f' of its largest value (tol '
              f'{MOE_FEATURE_TOL:.3e}, one bf16 step); {n_params / 1e6:.1f} M '
              f'parameters', flush=True)

        work_dir = os.path.join(root, 'work')
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, log = run_train_cli([PLUS_B, '--work-dir', work_dir,
                                    '--cfg-options', *options])
        times['train'] = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        train_recs = [r for r in log if r['mode'] == 'train']
        (epoch,) = [r for r in log if r['mode'] == 'epoch']
        steps = len(train_recs)
        val_batches = -(-sum(MOE_VAL_IMAGES) * 4 // MOE_BATCH)
        check(state.step == steps == MOE_STEPS_PER_SET * len(MOE_SETS),
              f'{steps} logged steps, state at step {state.step}, expected '
              f'{MOE_STEPS_PER_SET} per set')
        launches = check_launches('moe-train', steps, val_batches)
        del state
        torch.cuda.empty_cache()
        seen = sorted({r['dataset'] for r in train_recs})
        check(seen == list(range(len(MOE_SETS))), f'datasets in the log '
              f'{seen}')
        losses = [f'loss_{d}' for d in range(len(MOE_SETS))]
        for r in train_recs:
            check(all(np.isfinite(r[k]) for k in
                      losses + ['heatmap_loss', 'grad_norm']),
                  f'a non-finite metric in {r}')
            others = [r[k] for d, k in enumerate(losses) if d != r['dataset']]
            check(others == [0.0] * (len(MOE_SETS) - 1) and
                  r[f"loss_{r['dataset']}"] > 0, f'step {r["step"]} '
                  f'(dataset {r["dataset"]}) has the other heads\' losses '
                  f'{others}')
        ckpts = os.path.join(work_dir, 'ckpts')
        best = os.path.join(ckpts, 'best.pth')
        check(os.path.exists(best), 'no best.pth in the work dir')
        best_sd = torch.load(best, map_location='cpu', weights_only=True)
        mmpose = ('backbone.blocks.11.mlp.experts.5.weight',
                  'associate_keypoint_heads.4.final_layer.weight')
        check(all(k in best_sd for k in mmpose)
              and not any('expert_weight' in k or 'expert_bias' in k
                          for k in best_sd)
              and best_sd[mmpose[1]].shape[0] == 133
              and best_sd[mmpose[0]].shape == (192, 3072),
              'best.pth is not under the mmpose names')
        del best_sd
        step_s = statistics.median(step_times(log))
        first = [r for r in train_recs if r['epoch'] == 0][-1]
        share = first['data_time'] / first['time']
        ckpt_bytes = os.path.getsize(os.path.join(ckpts, 'epoch_0.pth'))
        best_bytes = os.path.getsize(best)
        print(f'moe-train: CLI (vitpose_tpu_torch.tools.train) on the '
              f'ViTPose+-B config (6 experts of part_dim 192, 6 heads of '
              f'17/14/16/17/17/133 channels, bf16, UDP, max_num_joints 133), '
              f'batch {MOE_BATCH}, 1 epoch of {steps} steps over six '
              f'synthetic sets (datasets {[r["dataset"] for r in train_recs]}'
              f'), logging every step: {launches[0]} K1 + {launches[1]} K2 '
              f'launches (12 + 12 per step, 24 K1 per val batch x '
              f'{val_batches}, all whole-pair); every other head\'s loss '
              f'exactly 0 in every step; step wall time median '
              f'{step_s * 1e3:.1f} ms = {MOE_BATCH / step_s:.1f} img/s; '
              f'data_time share {share:.3f} ({first["data_time"]:.2f} of '
              f'{first["time"]:.2f} s); AP {epoch["AP"]:.4f} (expert 0, '
              f'main head); epoch {epoch["epoch_time"]:.2f} s; last '
              f'heatmap_loss {train_recs[-1]["heatmap_loss"]:.6f}; '
              f'checkpoint {ckpt_bytes / 1e9:.3f} GB, best.pth '
              f'{best_bytes / 1e9:.3f} GB; peak device memory '
              f'{peak_gb:.2f} GB; whole run {times["train"]:.1f} s; on '
              f'{card}', flush=True)

        t0 = time.perf_counter()
        split_dir = os.path.join(root, 'split')
        subprocess.run([sys.executable, '-m',
                        'vitpose_tpu_torch.tools.model_split', best,
                        '--out-dir', split_dir], check=True,
                       capture_output=True, timeout=600)
        names = sorted(os.listdir(split_dir))
        check(names == sorted(f'{n}.pth' for n in (
            'coco', 'aic', 'mpii', 'ap10k', 'apt36k', 'wholebody')),
            f'model_split wrote {names}')
        times['split'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = test_cli.main([COCO_B, os.path.join(split_dir,
                                                        'coco.pth'),
                                   '--cfg-options', *val_options])
        times['eval'] = time.perf_counter() - t0
        diff = abs(stats['AP'] - epoch['AP'])
        check(diff <= MOE_AP_TOL, f'moe-train: the split COCO checkpoint '
              f'scores AP {stats["AP"]} with the COCO-B config, the runner '
              f'logged {epoch["AP"]} (tol {MOE_AP_TOL})')
        print(f'moe-train: model_split (python -m '
              f'vitpose_tpu_torch.tools.model_split) wrote {len(names)} '
              f'single-task checkpoints in {times["split"]:.1f} s; coco.pth '
              f'through the evaluation CLI with the plain COCO-B config: AP '
              f'{stats["AP"]:.6f} against the runner\'s {epoch["AP"]:.6f}, '
              f'difference {diff:.6f} (tol {MOE_AP_TOL})', flush=True)
        t0 = time.perf_counter()
        busy_ms = moe_step_profile(cfg, step_s, card)
        times['profile'] = time.perf_counter() - t0
    print('moe-train: kernel time per step '
          + ('not measured' if busy_ms is None else f'{busy_ms:.1f} ms')
          + ' (torch.profiler, one MoE step alone), card idle share of the '
          'runner\'s median step '
          + ('not measured' if busy_ms is None
             else f'{1 - busy_ms / (step_s * 1e3):.3f}')
          + '; phase times ' + ', '.join(f'{k} {v:.1f} s'
                                         for k, v in times.items())
          + f'; on {card}', flush=True)
    return launches, steps, val_batches


# moe-ref: two ViTPose+ steps at full ViTPose+-B width and depth on 3 crops
# whose datasets mix within each batch, so every block routes rows per
# expert (the runner's batches hold one dataset each and never do). Expert
# 5 is selected in step 1 only (step 2 moves it by its Adam moments and
# decay), experts 1, 3 and 4 never (decay alone), and heads 1, 3 and 4 see
# no sample (loss exactly 0, gradients exactly 0, BN statistics moving).
# The config's optimizer, warmup included, as train-ref's
MOE_REF_ROUTES = (np.array([5, 0, 5]), np.array([2, 2, 0]))
MOE_REF_JOINTS = 133                 # the mixture's max_num_joints
# moe-ref f32, CUDA against the CPU, in the units of moe_ref_distances:
# summation order. Head 0 trains on one sample of the three while its BN
# statistics take all three, so its gradients cancel more than train-ref's
# (batch 2, one head), and the first Adam steps turn them into sign flips of
# the tiny-gradient elements (the LayerNorm weights). Measured on the card
# (heatmap_loss / grad_norm / losses / grads / params / experts / bn_stats):
# CUDA vs CPU 8.8e-8 / 1.6e-4 / 3.0e-7 / 5.1e-3 / 3.0e-2 / 8.8e-3 /
# 1.3e-5; the CPU against itself on one thread instead of eight (measured
# once, not repeated by the phase), 8.8e-8 / 7.7e-6 / 2.4e-7 / 2.4e-3 /
# 4.0e-2 / 5.5e-3 / 9.2e-6. The bounds are about twice the larger of the two
MOE_REF_TOL = {'heatmap_loss': 1e-6, 'grad_norm': 1e-3, 'losses': 1e-6,
               'grads': 1e-2, 'params': 8e-2, 'experts': 2e-2,
               'bn_stats': 3e-5}


def moe_ref_batch():
    """3 crops of the synthetic canvases with MOE_REF_JOINTS random joints
    inside each person box, so that every head's channels carry targets,
    preprocessed on the CPU as the runner does (UDP)."""
    from vitpose_tpu_torch.data.pipeline import make_preprocess_fn
    imgs, records = synthetic_records(6, len(MOE_REF_ROUTES[0]))
    rng = np.random.RandomState(6)
    center = np.stack([r['center'] for r in records])
    scale = np.stack([r['scale'] for r in records])
    half = scale * 200 / 1.25 / 2           # the box, without the padding
    joints = center[:, None] + half[:, None] * rng.uniform(
        -0.9, 0.9, (len(records), MOE_REF_JOINTS, 2))
    vis = (rng.rand(len(records), MOE_REF_JOINTS) > 0.15)
    args = [torch.from_numpy(x) for x in (
        imgs, center, scale, np.zeros(len(records), np.float32),
        joints.astype(np.float32), vis.astype(np.float32))]
    return make_preprocess_fn((192, 256), (48, 64),
                              pad_num_joints=MOE_REF_JOINTS)(*args)


def moe_ref_run(cfg, device, batch):
    """Two make_moe_train_step steps of the runner's train state for `cfg`
    on `device`, step i with dataset_idx MOE_REF_ROUTES[i]: (the metrics of
    each step, the gradients of step 1 after the clip, the 2-step change of
    every parameter and BN statistic), on the CPU in f32."""
    from vitpose_tpu_torch.train.loop import build_train_state
    from vitpose_tpu_torch.train.step import make_moe_train_step
    state = build_train_state(cfg, 1, device)
    step = make_moe_train_step(state.model, len(cfg['data']['train']))
    batch = {k: v.to(device) for k, v in batch.items()}
    gen = torch.Generator(device=device).manual_seed(0)
    before = snapshot(state.model)
    metrics, grads = [], None
    for idx in MOE_REF_ROUTES:
        m = step(state, dict(batch, dataset_idx=idx), gen)
        metrics.append({k: v.item() for k, v in m.items()})
        if grads is None:
            grads = {n: p.grad.float().cpu()
                     for n, p in state.model.named_parameters()}
    after = snapshot(state.model)
    delta = {n: (after[n] - before[n]).float().cpu() for n in after}
    del state
    return metrics, grads, delta


def _rel(x, ref, rms):
    """|x - ref| over |ref|, as the max of each (rms False) or as RMS (rms
    True); 0 where both are 0, inf where only `ref` is."""
    diff, scale = ((x - ref).norm(), ref.norm()) if rms else \
        ((x - ref).abs().max(), ref.abs().max())
    if scale == 0:
        return 0.0 if diff == 0 else float('inf')
    return (diff / scale).item()


def moe_ref_distances(run, ref):
    """Distances of a moe_ref_run from the reference run, as
    ref_distances's: relative heatmap_loss and grad_norm (the larger of the
    two steps) and `losses`, every loss_d of a dataset in its step's batch;
    `grads`, `bn_stats` and `params` as there; `experts` the RMS ratio of
    each expert's rows (weight and bias) of every block. Returns those and
    {'grads', 'params', 'experts', 'bn'}: the distances per tensor (per
    expert)."""
    (ms, g, d), (mrs, gr, dr) = run, ref
    rel = {k: max(abs(m[k] - mr[k]) / abs(mr[k]) for m, mr in zip(ms, mrs))
           for k in ('heatmap_loss', 'grad_norm')}
    rel['losses'] = max(abs(m[f'loss_{e}'] - mr[f'loss_{e}'])
                        / abs(mr[f'loss_{e}'])
                        for m, mr, idx in zip(ms, mrs, MOE_REF_ROUTES)
                        for e in set(idx.tolist()))
    grads = {n: _rel(g[n], gr[n], False) for n in gr}
    rel['grads'] = max(grads.values())
    params = {n: _rel(d[n], dr[n], True) for n in gr}
    rel['params'] = max(params.values())
    experts = {}
    for n in gr:
        if n.endswith('mlp.expert_weight'):
            b = n[:-len('weight')] + 'bias'
            for e in range(dr[n].shape[0]):
                experts[f'{n[:-len("expert_weight")]}experts.{e}'] = _rel(
                    torch.cat([d[n][e].ravel(), d[b][e]]),
                    torch.cat([dr[n][e].ravel(), dr[b][e]]), True)
    rel['experts'] = max(experts.values())
    bn = {n: _rel(d[n], dr[n], False) for n in dr if n not in gr}
    rel['bn_stats'] = max(bn.values())
    return rel, dict(grads=grads, params=params, experts=experts, bn=bn)


def check_moe_run(run, what):
    """Each step's absent datasets: loss exactly 0; step 1's absent heads:
    gradients exactly 0; every metric finite."""
    metrics, grads, _ = run
    for i, (m, idx) in enumerate(zip(metrics, MOE_REF_ROUTES)):
        check(all(np.isfinite(v) for v in m.values()),
              f'{what}: non-finite metrics in step {i + 1}: {m}')
        absent = [f'loss_{e}' for e in range(6) if e not in idx]
        check(all(m[k] == 0.0 for k in absent), f'{what}: step {i + 1} '
              f'(datasets {idx.tolist()}) has losses {m}')
    heads = ['keypoint_head.' if e == 0 else f'associate_keypoint_heads.'
             f'{e - 1}.' for e in range(6) if e not in MOE_REF_ROUTES[0]]
    nonzero = [n for n, g in grads.items()
               if n.startswith(tuple(heads)) and g.abs().max() > 0]
    check(not nonzero, f'{what}: heads of no sample in step 1 have '
          f'gradients in {nonzero[:4]}')


def phase_moe_ref(card):
    """make_moe_train_step at full ViTPose+-B width and depth (fused
    attention on, drop_path 0) from the runner's seeded weights, on CUDA
    (K1 + K2, the experts' per-row products) and on the CPU (plain
    attention): f32 (TF32 off) within MOE_REF_TOL, bf16 CUDA as close to
    the f32 CPU answer as the bf16 CPU path is (within BF16_FACTOR)."""
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.utils.config import apply_options, load_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    batch = moe_ref_batch()
    runs, cfgs = {}, {}
    for dtype in ('float32', 'bfloat16'):
        cfgs[dtype] = apply_options(load_config(PLUS_B), [
            f'model.dtype={dtype}',
            'model.backbone_overrides.fused_attention=True',
            'model.backbone_overrides.drop_path_rate=0.0'])
        for dev in ('cuda', 'cpu'):
            reset_counts()
            runs[dev, dtype] = moe_ref_run(cfgs[dtype], dev, batch)
            check_moe_run(runs[dev, dtype], f'moe-ref {dev} {dtype}')
            if dev == 'cuda':
                n = (fused_attention.launches, fused_attention_bwd.launches)
                check(n == (24, 24), f'moe-ref: two CUDA steps launched K1, '
                      f'K2 {n} times, expected 24 each')
    ref = runs['cpu', 'float32']
    f32, f32_per = moe_ref_distances(runs['cuda', 'float32'], ref)
    print('moe-ref: f32 (TF32 off) CUDA+K1+K2 vs CPU plain, ViTPose+-B full '
          f'width and depth, batch {len(MOE_REF_ROUTES[0])}, datasets '
          f'{[r.tolist() for r in MOE_REF_ROUTES]} in two steps, drop_path '
          '0: ' + ', '.join(f'{k} {v:.3e} (tol {MOE_REF_TOL[k]:g})'
                            for k, v in f32.items())
          + '; losses ' + ', '.join(
              f'step {i + 1} ' + ' '.join(
                  f'{k} {v:.6f}' for k, v in m.items() if k.startswith('loss'))
              for i, m in enumerate(ref[0]))
          + '; largest distances: ' + '; '.join(
              f'{k} {worst(v)}' for k, v in f32_per.items()), flush=True)
    for k, tol in MOE_REF_TOL.items():
        check(f32[k] <= tol, f'moe-ref f32: {k} differs by {f32[k]} '
              f'(tol {tol})')
    gpu, gpu_per = moe_ref_distances(runs['cuda', 'bfloat16'], ref)
    cpu, cpu_per = moe_ref_distances(runs['cpu', 'bfloat16'], ref)
    print('moe-ref: bf16 against the f32 CPU answer, CUDA+K1+K2 / CPU '
          'plain: ' + ', '.join(f'{k} {gpu[k]:.3e} / {cpu[k]:.3e}'
                                for k in gpu)
          + f' (CUDA at most {BF16_FACTOR}x CPU, + 2^-8 for the scalars); '
          f'largest expert distances, CUDA: {worst(gpu_per["experts"])}; '
          f'CPU: {worst(cpu_per["experts"])}; '
          f'{time.perf_counter() - t0:.1f} s on {card}', flush=True)
    for k in gpu:
        floor = 2.0 ** -8 if k in ('heatmap_loss', 'grad_norm', 'losses') \
            else 0.0
        check(gpu[k] <= BF16_FACTOR * cpu[k] + floor,
              f'moe-ref bf16: CUDA {k} is {gpu[k]} from the f32 answer, '
              f'the bf16 CPU path {cpu[k]}')


# ops: K1 and K2 through the dispatcher (torch.library custom ops) against
# the same kernels called as the port called them before the ops (ctypes
# wrappers under a Python autograd.Function), priced per call and per serve
# batch and train step, in turns
OPS_SHAPE = (2, 192, 12, 64)         # opcheck, bf16
OPS_CALL_SHAPE = (8, 192, 12, 64)    # the 8-box serve call's K1
OPS_HOST_CALLS = 400
OPS_TURN_BATCHES = 2                 # timed serve batches per turn
OPS_TURN_STEPS = 5                   # timed train steps per turn


class _DirectK3(torch.autograd.Function):
    """K3 as the port had it before the ops: the kernel wrappers under a
    Python Function, outside the dispatcher (the baseline that prices the
    custom ops)."""

    @staticmethod
    def forward(ctx, q, k, v):
        from vitpose_tpu_torch.ops.attention import fused_attention
        ctx.save_for_backward(q, k, v)
        return fused_attention(q, k, v)

    @staticmethod
    def backward(ctx, g):
        from vitpose_tpu_torch.ops.attention import fused_attention_bwd
        return fused_attention_bwd(*ctx.saved_tensors, g.contiguous())


def direct_attention(q, k, v):
    from vitpose_tpu_torch.ops.attention import fused_attention
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _DirectK3.apply(q, k, v)
    return fused_attention(q, k, v)


def host_us(fn, calls=OPS_HOST_CALLS):
    """Host microseconds per fn() over `calls` back-to-back calls whose
    device work is shorter than their host work (one sync at the end)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def in_turns(runs):
    """{name: mean of its turns} of the two runs[name]() (each returns a
    time), timed in turns (first, second, second, first), and the turns."""
    a, b = runs
    turns = [(name, runs[name]()) for name in (a, b, b, a)]
    return ({name: statistics.mean(t for n, t in turns if n == name)
             for name in runs}, turns)


def wall_ms(fn, reps):
    """Median wall ms of fn() over `reps` calls, each ended by a sync."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_ops(model, card):
    phase_t0 = time.perf_counter()
    from vitpose_tpu_torch.models import vit
    from vitpose_tpu_torch.ops import attention as attn
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs
    gen = torch.Generator(device='cuda').manual_seed(5)
    qkv = torch.randn(*OPS_SHAPE[:2], 3, *OPS_SHAPE[2:], generator=gen,
                      device='cuda', dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    g = torch.randn(OPS_SHAPE, generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    scale = OPS_SHAPE[-1] ** -0.5
    t0 = time.perf_counter()
    for op, args in ((torch.ops.vitpose.attention_fwd.default,
                      (q, k, v, scale)),
                     (torch.ops.vitpose.attention_bwd.default,
                      (q, k, v, g, scale))):
        res = torch.library.opcheck(op, args)
        check(all(r == 'SUCCESS' for r in res.values()),
              f'opcheck {op}: {res}')
    opcheck_s = time.perf_counter() - t0
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    reset_counts()
    out = attn.attention(*leaves)
    out.backward(g)
    torch.cuda.synchronize()
    counts = (attn.fused_attention.launches,
              attn.fused_attention_bwd.launches,
              attn.fused_attention.design_launches['pair'],
              attn.fused_attention_bwd.design_launches['pair'])
    check(counts == (1, 1, 1, 1), f'one K3 call through the ops counted '
          f'K1, K2 (pair K1, pair K2) {counts}, expected one each')
    ref = attn.reference_attention(q, k, v)
    check(torch.equal(out.detach(), attn.fused_attention(q, k, v)),
          'the op and the wrapper gave different K1 outputs')
    err = (out.detach().float() - ref.float()).abs().max().item()
    atol, rtol = TOLS[torch.bfloat16]
    check(err <= atol + rtol * ref.float().abs().max().item(),
          f'K1 through the op is {err} from its plain version')

    qkv8 = torch.randn(*OPS_CALL_SHAPE[:2], 3, *OPS_CALL_SHAPE[2:],
                       generator=gen, device='cuda', dtype=torch.bfloat16)
    q8, k8, v8 = qkv8.unbind(2)
    s8 = OPS_CALL_SHAPE[-1] ** -0.5
    host, host_turns = in_turns({
        'op': lambda: host_us(
            lambda: torch.ops.vitpose.attention_fwd(q8, k8, v8, s8)),
        'direct': lambda: host_us(
            lambda: attn.fused_attention(q8, k8, v8, s8))})
    # one K3 forward and backward at one crop's shape, where the kernels
    # take a few microseconds: the host price of a pair in a train step
    leaf1 = qkv8[:1].detach().clone().requires_grad_()
    g1 = torch.randn(1, *OPS_CALL_SHAPE[1:], generator=gen, device='cuda',
                     dtype=torch.bfloat16)

    def pair(fn):
        return lambda: fn(*leaf1.unbind(2)).backward(g1)

    k3, k3_turns = in_turns({
        'op': lambda: host_us(pair(attn.attention), OPS_HOST_CALLS // 4),
        'direct': lambda: host_us(pair(direct_attention),
                                  OPS_HOST_CALLS // 4)})

    n = 256
    rng = np.random.RandomState(0)
    boxes = np.stack([rng.uniform(0, 480, n), rng.uniform(0, 260, n),
                      rng.uniform(60, 160, n), rng.uniform(120, 220, n)], 1)
    iw, ih = model.image_size
    c, s = bbox_xywh2cs(boxes.astype(np.float32), iw / ih)
    c, s = c.cuda(), s.cuda()
    img = torch.from_numpy(scene(0, grid_boxes(rng, 4, 2))).cuda()
    imgs = img[None].expand(n, *img.shape)
    state, step, preprocess, info = train_setup(SERVE_CFG, 'cuda')
    batch = preprocess(*train_inputs(0, TRAIN_BATCH, info, 'cuda'))
    tgen = torch.Generator(device='cuda').manual_seed(0)

    def timed(fn, reps):
        def run(name):
            vit.attention = attn.attention if name == 'op' \
                else direct_attention
            try:
                fn()                                      # warm-up
                return wall_ms(fn, reps)
            finally:
                vit.attention = attn.attention
        return run

    serve = timed(lambda: model.infer_batch(imgs, c, s), OPS_TURN_BATCHES)
    train = timed(lambda: step(state, batch, tgen), OPS_TURN_STEPS)
    serve_ms, serve_turns = in_turns({'op': lambda: serve('op'),
                                      'direct': lambda: serve('direct')})
    train_ms, train_turns = in_turns({'op': lambda: train('op'),
                                      'direct': lambda: train('direct')})
    del state, step, batch
    torch.cuda.empty_cache()
    per_call = host['op'] - host['direct']
    print(f'ops: opcheck of vitpose::attention_fwd and attention_bwd on '
          f'CUDA at {OPS_SHAPE} bf16 passed ({opcheck_s:.1f} s); one K3 '
          f'call through the ops launched K1 and K2 once each (whole-pair), '
          f'K1 {err:.3e} from plain; host us per K1 call at '
          f'{OPS_CALL_SHAPE}: op {host["op"]:.1f}, direct wrapper '
          f'{host["direct"]:.1f} (turns '
          + ', '.join(f'{nm} {t:.1f}' for nm, t in host_turns)
          + f'), so the dispatcher adds {per_call:.1f} us per call; host us '
          f'per K3 forward + backward at (1, 192, 12, 64): op '
          f'{k3["op"]:.1f}, direct {k3["direct"]:.1f} (turns '
          + ', '.join(f'{nm} {t:.1f}' for nm, t in k3_turns) + '); '
          f'256-crop serve batch (24 K1) op {serve_ms["op"]:.2f} / direct '
          f'{serve_ms["direct"]:.2f} ms (turns '
          + ', '.join(f'{nm} {t:.2f}' for nm, t in serve_turns)
          + f'); train step (12 K1 + 12 K2) op {train_ms["op"]:.2f} / '
          f'direct {train_ms["direct"]:.2f} ms (turns '
          + ', '.join(f'{nm} {t:.2f}' for nm, t in train_turns)
          + f'); phase {time.perf_counter() - phase_t0:.1f} s on {card}',
          flush=True)
    return {'host_us_per_call': host, 'dispatcher_us_per_call': per_call,
            'host_us_per_k3_pair': k3,
            'serve_batch_ms': serve_ms, 'train_step_ms': train_ms}


def peaks_checkpoint(root, config, name):
    """init_pose_model(config) on the card with shape_peaks weights, saved
    as root/name.pth; returns the path."""
    from vitpose_tpu_torch.api import init_pose_model
    pm = init_pose_model(config, device='cuda')
    shape_peaks(pm.model)
    path = os.path.join(root, f'{name}.pth')
    torch.save(pm.model.state_dict(), path)
    del pm
    return path


# export: the CLI on the COCO-B config at --batch 8, then the .pt2 loaded
# in this process; exported and eager are the same kernels in the same
# order, so their heatmaps should agree to within one bf16 step of the
# largest value (EXPORT_TOL of max |eager|)
EXPORT_BATCHES = (8, 256)
EXPORT_TOL = 2.0 ** -8
EXPORT_REPS = 3


def phase_export(card, root, ckpt):
    phase_t0 = time.perf_counter()
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.ops.attention import fused_attention
    from vitpose_tpu_torch.tools import export
    path = os.path.join(root, 'vitpose_b_b8.pt2')
    t0 = time.perf_counter()
    # the program main() reloaded from the .pt2 with load_exported, in this
    # process
    program, cli_err = export.main([COCO_B, '--checkpoint', ckpt, '--out',
                                    path, '--batch',
                                    str(EXPORT_BATCHES[0])])
    cli_s = time.perf_counter() - t0
    in_graph = program.graph_module.code.count('vitpose.attention_fwd')
    check(in_graph == 24, f'the exported graph holds {in_graph} '
          'vitpose.attention_fwd calls, expected 12 blocks x 2 passes')
    pm = init_pose_model(COCO_B, checkpoint=ckpt, device='cuda')
    eager = export.InferModule(pm.model, pm.flip_index_tensor()).eval()
    cpu_gen = torch.Generator().manual_seed(1)
    rows, launches = [], None
    for n in EXPORT_BATCHES:
        x = torch.randn((n, 256, 192, 3), generator=cpu_gen).cuda()
        run = (program.module() if n == EXPORT_BATCHES[0]
               else export.export_program(eager, x).module())
        with torch.no_grad():
            reset_counts()
            out = run(x)
            torch.cuda.synchronize()
            if launches is None:
                launches = fused_attention.launches
            ref = eager(x)
            check_shapes_held(f'export batch {n}')
            err = (out - ref).abs().max().item()
            bound = EXPORT_TOL * ref.abs().max().item()
            check(torch.isfinite(out).all().item() and err <= bound,
                  f'exported batch {n}: {err} from eager, bound {bound}')
            ms, turns = in_turns(
                {'exported': lambda: wall_ms(lambda: run(x), EXPORT_REPS),
                 'eager': lambda: wall_ms(lambda: eager(x), EXPORT_REPS)})
        rows.append(dict(batch=n, err=err, bound=bound,
                         exported_ms=ms['exported'], eager_ms=ms['eager'],
                         turns=turns))
    check(launches == 24, f'the exported program launched K1 {launches} '
          'times in a call, expected 24')
    del program, pm, eager
    torch.cuda.empty_cache()
    print(f'export: the CLI on {COCO_B} --batch 8 wrote '
          f'{os.path.getsize(path) / 1e6:.1f} MB in {cli_s:.1f} s (its '
          f'reload parity max err {cli_err:.2e}), reloaded there by '
          f'load_exported: {in_graph} vitpose.attention_fwd in the graph, '
          f'{launches} K1 launches per call; ' + '; '.join(
              f'batch {r["batch"]}: max abs err {r["err"]:.3e} against '
              f'eager (bound {r["bound"]:.3e}), exported '
              f'{r["exported_ms"]:.2f} / eager {r["eager_ms"]:.2f} ms per '
              f'call (turns ' + ', '.join(
                  f'{nm} {t:.2f}' for nm, t in r['turns']) + ')'
              for r in rows)
          + f'; phase {time.perf_counter() - phase_t0:.1f} s on {card}',
          flush=True)
    return launches, rows


# demos: the top-down demos on a 480x640 image with 3 boxes and a 4-frame
# video of it; the webcam on a 16-frame video (max_frames binds at 10)
DEMO_FRAMES = 4
WEBCAM_FRAMES = 16
WEBCAM_MAX_FRAMES = 10


def write_video(path, img, frames):
    """`frames` frames of the RGB image, each shifted by 2 more pixels, as
    an MJPG .avi (read back: it fails unless every frame is there)."""
    from vitpose_tpu_torch.utils.video import video_writer
    writer = video_writer(path, 10, (img.shape[1], img.shape[0]))
    for i in range(frames):
        writer.write(np.ascontiguousarray(np.roll(img, 2 * i, axis=1)[..., ::-1]))
    writer.release()
    check(count_frames(path) == frames, f'{path}: wrote {frames} frames, '
          f'read back {count_frames(path)}')
    return path


def count_frames(path):
    import cv2
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def phase_demos(card, root, ckpt):
    phase_t0 = time.perf_counter()
    import cv2
    from vitpose_tpu_torch.demo import (face_img_demo, face_video_demo,
                                        top_down_img_demo,
                                        top_down_img_demo_with_det,
                                        top_down_pose_tracking_demo,
                                        top_down_video_demo,
                                        top_down_video_demo_with_det,
                                        webcam_demo)
    from vitpose_tpu_torch.ops.attention import fused_attention
    boxes = grid_boxes(np.random.RandomState(3), 3, 1)
    img = scene(3, boxes)
    img_path = os.path.join(root, 'people.jpg')
    cv2.imwrite(img_path, np.ascontiguousarray(img[..., ::-1]))
    video = write_video(os.path.join(root, 'people.avi'), img, DEMO_FRAMES)
    xywh = [[float(v) for v in b[:4]] for b in boxes]
    docs = {'ann': {'images': [{'id': 1, 'file_name': 'people.jpg'}],
                    'annotations': [{'image_id': 1, 'bbox': b}
                                    for b in xywh]},
            'det': [{'image_id': 1, 'category_id': 1, 'bbox': b,
                     'score': 0.9} for b in xywh],
            'frames': {str(i): [[b[0] + 2 * i] + b[1:] + [0.9] for b in xywh]
                       for i in range(DEMO_FRAMES)}}
    for name, doc in docs.items():
        with open(os.path.join(root, f'{name}.json'), 'w') as f:
            json.dump(doc, f)
    face_ckpt = peaks_checkpoint(
        root, {'variant': 's', 'dataset': '300w', 'out_channels': 68},
        'face_s_peaks')
    out = os.path.join(root, 'vis')
    j = {name: os.path.join(root, f'{name}.json') for name in docs}
    b_args = ['--variant', COCO_B, '--checkpoint', ckpt]
    demos = {
        'top_down_img_demo': (top_down_img_demo, [img_path, '--json-file',
                              j['ann'], '--out-img-root', out] + b_args,
                              1, 'vis_people.jpg'),
        'top_down_img_demo_with_det': (
            top_down_img_demo_with_det, [img_path, '--det-json', j['det'],
                                         '--out-img-root', out] + b_args,
            1, 'vis_det_people.jpg'),
        'top_down_video_demo': (top_down_video_demo, [
            video, '--out-video-root', out] + b_args, DEMO_FRAMES,
            'vis_people.avi'),
        'top_down_video_demo_with_det': (top_down_video_demo_with_det, [
            video, '--det-json', j['frames'], '--out-video-root', out]
            + b_args, DEMO_FRAMES, 'vis_det_people.avi'),
        'top_down_pose_tracking_demo': (top_down_pose_tracking_demo, [
            video, '--det-json', j['frames'], '--out-video-root', out]
            + b_args, DEMO_FRAMES, 'track_people.avi'),
        'face_img_demo': (face_img_demo, [
            img_path, '--checkpoint', face_ckpt, '--out-img-root', out], 1,
            'vis_face_people.jpg'),
        'face_video_demo': (face_video_demo, [
            video, '--checkpoint', face_ckpt, '--out-video-root', out],
            DEMO_FRAMES, 'face_people.avi'),
        'webcam_demo': (webcam_demo, [
            '--input', video, '--out', os.path.join(out, 'webcam.avi'),
            '--sync'] + b_args, DEMO_FRAMES, 'webcam.avi'),
    }
    per_frame, fps, wall = {}, {}, {}
    for name, (module, args, frames, out_name) in demos.items():
        reset_counts()
        t0 = time.perf_counter()
        module.main(args)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        check_shapes_held(name)
        launches = fused_attention.launches
        per_frame[name] = launches / frames
        want = 0 if name.startswith('face') else 24
        check(launches == want * frames, f'{name}: {launches} K1 launches '
              f'over {frames} frames, expected {want} per frame')
        path = os.path.join(out, out_name)
        check(os.path.isfile(path), f'{name} wrote no {path}')
        if frames > 1:
            got = count_frames(path)
            check(got == frames, f'{name}: {path} holds {got} frames, '
                  f'expected {frames}')
            fps[name] = frames / wall[name]
    print(f'demos: 8 top-down demos on the card, a 480x640 image with '
          f'{len(boxes)} boxes and a {DEMO_FRAMES}-frame MJPG video; K1 '
          f'launches per frame: ' + ', '.join(
              f'{n} {v:g}' for n, v in per_frame.items())
          + '; every output written (videos read back frame for frame); '
          'wall s of main (model build included): ' + ', '.join(
              f'{n} {v:.2f}' for n, v in wall.items())
          + '; frames/s over main: ' + ', '.join(
              f'{n} {v:.1f}' for n, v in fps.items())
          + f'; phase {time.perf_counter() - phase_t0:.1f} s on {card}',
          flush=True)
    return per_frame, fps


WEBCAM_TIMEOUT_S = 120
# threaded, the pose node takes the latest frame and the display does not
# wait for it, so it skips frames whenever the camera outpaces the models:
# a slow host inferred 4 frames for 10 shown at the config's 20 frames/s.
# So the threaded run paces the camera at 1 / WEBCAM_PACE of the model
# chain's rate (detector plus pose node, medians of the synchronous run);
# a live node then infers about every frame, and one that stops after a
# few frames infers far fewer than this share of the frames shown
WEBCAM_PACE = 3
WEBCAM_MIN_INFERRED_SHARE = 0.5


@contextlib.contextmanager
def thread_errors():
    """Collect, as 'thread: error' strings, every exception that ends a
    thread inside the block (threading.excepthook), and still report it."""
    import threading
    errors, hook = [], threading.excepthook

    def record(args):
        errors.append(f'{args.thread.name if args.thread else "?"}: '
                      f'{args.exc_type.__name__}: {args.exc_value}')
        hook(args)

    threading.excepthook = record
    try:
        yield errors
    finally:
        threading.excepthook = hook


def webcam_run(runner_cfg, label):
    """Run the webcam runner built from `runner_cfg`, ended by its `_exit_`
    event after WEBCAM_TIMEOUT_S if it has not ended by then; fails if a
    node's thread raised, was not alive when the last frame was shown or
    still runs when the runner returns, or if K1 launched at a shape no
    kernel phase holds. Returns (frames shown, frames the pose node
    inferred, K1 launches, wall s of the run without the model build, the
    model chain's s per frame: the sum of the detector's and the pose
    node's median process times)."""
    import threading
    from vitpose_tpu_torch.ops.attention import fused_attention
    from vitpose_tpu_torch.webcam import WebcamRunner
    from vitpose_tpu_torch.webcam.model_nodes import (
        DetectorNode, TopDownPoseEstimatorNode)
    runner = WebcamRunner(**runner_cfg)
    models = [n for n in runner.node_list
              if isinstance(n, (DetectorNode, TopDownPoseEstimatorNode))]
    pose = [n for n in models if isinstance(n, TopDownPoseEstimatorNode)][0]
    spent = {}

    def timed(node):
        process, times = node.process, spent.setdefault(node.name, [])

        def run(msgs):
            t = time.perf_counter()
            out = process(msgs)
            times.append(time.perf_counter() - t)
            return out
        node.process = run

    for node in models:
        timed(node)
    alive_at_last = {}

    def on_display(img, msg):
        if runner.frame_count == runner.max_frames:
            alive_at_last.update((n.name, n.is_alive())
                                 for n in runner.node_list)

    runner.on_display = on_display
    watchdog = threading.Timer(WEBCAM_TIMEOUT_S,
                               lambda: runner.event_manager.set('_exit_'))
    watchdog.start()
    reset_counts()
    t0 = time.perf_counter()
    with thread_errors() as errors:
        try:
            shown = runner.run()
            torch.cuda.synchronize()
        finally:
            watchdog.cancel()
    check(not errors, f'webcam {label}: a node thread raised: {errors}')
    check(len(alive_at_last) == len(runner.node_list)
          and all(alive_at_last.values()),
          f'webcam {label}: node threads not alive when the last frame was '
          f'shown: {[n for n, a in alive_at_last.items() if not a] or "none recorded"}')
    running = [n.name for n in runner.node_list if n.is_alive()]
    check(not running, f'webcam {label}: node threads still running after '
          f'the run: {running}')
    check_shapes_held(f'webcam {label}')
    chain_s = sum(float(np.median(spent[n.name])) for n in models
                  if spent[n.name])
    return shown, len(spent[pose.name]), fused_attention.launches, \
        time.perf_counter() - t0, chain_s


def phase_webcam(card, root, ckpt):
    phase_t0 = time.perf_counter()
    import copy
    from vitpose_tpu_torch.tools import run_webcam
    boxes = grid_boxes(np.random.RandomState(4), 3, 1)
    video = write_video(os.path.join(root, 'webcam_in.avi'),
                        scene(4, boxes), WEBCAM_FRAMES)
    base = run_webcam.runner_config(run_webcam.parse_args([]))
    results = {}
    chain_s = None
    for mode, sync in (('synchronous', True), ('threaded', False)):
        cfg = copy.deepcopy(base)
        check(cfg['synchronous'] is False, 'the example config is not '
              'threaded by default')
        cfg.update(camera_id=video, show=False, synchronous=sync,
                   max_frames=WEBCAM_MAX_FRAMES)
        if not sync:
            cfg.update(camera_fps=min(cfg['camera_fps'],
                                      1.0 / (WEBCAM_PACE * chain_s)))
        for node in cfg['nodes']:
            if node['type'] == 'TopDownPoseEstimatorNode':
                node.update(model_config=COCO_B, model_checkpoint=ckpt)
            if node['type'] == 'RecorderNode':
                node.update(out_video_file=os.path.join(
                    root, f'record_{mode}.avi'), out_video_codec='MJPG')
        shown, inferred, launches, wall, chain = webcam_run(cfg, mode)
        if sync:
            chain_s = chain
        check(shown == WEBCAM_MAX_FRAMES, f'webcam {mode}: {shown} frames '
              f'shown, expected {WEBCAM_MAX_FRAMES}')
        check(inferred >= 1 and launches == 24 * inferred,
              f'webcam {mode}: {launches} K1 launches over {inferred} '
              'inferred frames, expected 24 each')
        least = shown if sync else WEBCAM_MIN_INFERRED_SHARE * shown
        check(inferred >= least, f'webcam {mode}: {inferred} frames '
              f'inferred for {shown} shown at {cfg["camera_fps"]:.3g} '
              f'camera frames/s, expected at least {least:g}')
        results[mode] = dict(shown=shown, inferred=inferred,
                             k1=launches, fps=shown / wall, wall_s=wall,
                             camera_fps=cfg['camera_fps'], chain_ms=1e3 * chain)
    # the example's RecorderNode writes record.mp4 (mp4v) in the working
    # directory from its own thread: a codec that cannot open fails here,
    # not as a recorder thread that dies and stalls the app
    from vitpose_tpu_torch.utils.video import video_writer
    video_writer(os.path.join(root, 'probe.mp4'), 20, (640, 480)).release()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        t0 = time.perf_counter()
        with thread_errors() as errors:
            runner = run_webcam.main([
                '--cfg-options', f'runner.camera_id={video}',
                'runner.show=False',
                f'runner.max_frames={WEBCAM_MAX_FRAMES}'])
        cli_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    check(not errors, f'run_webcam: a node thread raised: {errors}')
    check(runner.frame_count == WEBCAM_MAX_FRAMES, f'run_webcam showed '
          f'{runner.frame_count} frames, expected {WEBCAM_MAX_FRAMES}')
    print('webcam: the examples/pose_estimation.py runner on the COCO-B '
          f'config (bf16, K1), a {WEBCAM_FRAMES}-frame video, max_frames '
          f'{WEBCAM_MAX_FRAMES}, headless: ' + '; '.join(
              f'{m}: {r["shown"]} frames shown, {r["inferred"]} inferred, '
              f'{r["k1"]} K1 launches, {r["fps"]:.1f} frames/s shown '
              f'({r["wall_s"]:.2f} s) at {r["camera_fps"]:.3g} camera '
              f'frames/s, model chain {r["chain_ms"]:.1f} ms per frame'
              for m, r in results.items())
          + f'; tools/run_webcam.py (ViT-S f32, the config\'s own model) '
          f'showed {runner.frame_count} frames in {cli_s:.2f} s; phase '
          f'{time.perf_counter() - phase_t0:.1f} s on {card}', flush=True)
    return results


# --- CNN top-down: ResNet-50 and HRNet-W32 through GenericTopDown ----------

HRNET_CFG = 'vitpose_tpu/configs/coco/hrnet_w32_coco_256x192.py'
RES50_CFG = 'vitpose_tpu/configs/coco/res50_coco_256x192.py'
CNN_CONFIGS = (('hrnet_w32', HRNET_CFG), ('res50', RES50_CFG))
CNN_SERVE_TURNS = 1                  # timed 256-crop batches per model
CNN_TIMED_STEPS = 1                  # timed train steps per model
# cnn-ref f32 (TF32 off): heatmaps within CNN_HM_RTOL of max |CPU heatmap|
# (summation order through 50 to 300 convs), and a keypoint is decisive
# where its top-2 gap and both neighbour differences at the argmax (the
# quarter-pixel shift of the 'default' decode) exceed 10 such bounds
CNN_HM_RTOL = 1e-4
CNN_DECISIVE_BOUNDS = 10
CNN_EVAL_IMAGES = (28, 4)            # 128 boxes, 2 batches of 64
TD_EVAL_IMAGES = (60, 4)             # 256 boxes, 4 batches of 64
CNN_TRAIN_IMAGES = (40, 0)           # 140 GT persons: 2 steps of 64
CNN_CLI_STEPS = 2
PHOTOMETRIC_IMAGES = (40, 0)         # 140 GT persons: 2 steps of 64
CNN_APP_REQUESTS = 5
# cnn-train-ref, ResNet-50 at batch 2, in the units of ref_distances: CUDA
# f32 from an f64 run on the CPU at most CNN_REF_FACTOR times the CPU f32's
# own distance from it, plus the f32 floor of train-ref (TRAIN_REF_TOL). A
# BN over two crops whose channels are nearly constant (crops padded
# outside the canvas) takes its variance as E[x^2] - E[x]^2, flax's
# formula, and loses most digits there, so the CPU's f32 error, not f32's
# epsilon, sets the scale
CNN_REF_FACTOR = 4.0
# a gradient below this share of the largest in the f64 run is nought but
# for rounding (a context block's conv_mask bias: its softmax over H x W
# does not change when one constant is added to every logit)
GRAD_NOISE_FLOOR = 1e-6


def torch_tf32_defaults():
    """TF32 as torch starts: on for cuDNN convs, off for matmuls (serve-ref
    and train-ref turn both off)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def cnn_model_dict(path, dtype=None):
    """A config file's model dict, its backbone and head in `dtype` when
    given."""
    from vitpose_tpu_torch.utils.config import load_config
    mdict = dict(load_config(path)['model'])
    if dtype:
        mdict['dtype'] = dtype
        mdict['backbone_overrides'] = dict(
            mdict.get('backbone_overrides', {}), dtype=dtype)
    return mdict


def count_ops(run):
    """(conv and deconv MACs, BatchNorm'd elements) of the F.conv2d,
    F.conv_transpose2d and F.batch_norm calls of run(), from their shapes:
    a conv's MACs are its outputs times in/groups times the kernel's area,
    a transposed conv's its inputs times out/groups times the area."""
    calls = {'macs': 0, 'bn': 0}
    conv, deconv, bn = F.conv2d, F.conv_transpose2d, F.batch_norm

    def conv_c(x, w, *a, **k):
        y = conv(x, w, *a, **k)
        calls['macs'] += y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    def deconv_c(x, w, *a, **k):
        calls['macs'] += x.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return deconv(x, w, *a, **k)

    def bn_c(x, *a, **k):
        calls['bn'] += x.numel()
        return bn(x, *a, **k)

    F.conv2d, F.conv_transpose2d, F.batch_norm = conv_c, deconv_c, bn_c
    try:
        with torch.no_grad():
            run()
    finally:
        F.conv2d, F.conv_transpose2d, F.batch_norm = conv, deconv, bn
    return calls['macs'], calls['bn']


def conv_counts(pm):
    """count_ops of one crop through pm.model, on the card."""
    iw, ih = pm.image_size
    return count_ops(lambda: pm.model(torch.zeros(1, ih, iw, 3,
                                                  device=pm.device)))


def check_grouped_counts():
    """count_ops against a hand count for a grouped conv (ResNeXt-50's
    layer1 conv2: 128 channels in 32 groups, 3x3, on 64x48) and a grouped
    transposed conv (the ViPNAS-MobileNetV3 head's first: 160 channels in
    160 groups, 4x4/2, 8x6 -> 16x12); returns their MACs."""
    x = torch.zeros(1, 128, 64, 48, device='cuda')
    w = torch.zeros(128, 4, 3, 3, device='cuda')
    conv_macs, _ = count_ops(lambda: F.conv2d(x, w, padding=1, groups=32))
    # every output: 4 inputs of its group times 9 taps
    check(conv_macs == 128 * 64 * 48 * 4 * 9, f'count_ops: grouped conv '
          f'{conv_macs} MACs, by hand {128 * 64 * 48 * 4 * 9}')
    x = torch.zeros(1, 160, 8, 6, device='cuda')
    w = torch.zeros(160, 1, 4, 4, device='cuda')
    deconv_macs, _ = count_ops(lambda: F.conv_transpose2d(
        x, w, stride=2, padding=1, groups=160))
    # every input scatters to 1 output channel over the 4x4 taps
    check(deconv_macs == 160 * 8 * 6 * 16, f'count_ops: grouped deconv '
          f'{deconv_macs} MACs, by hand {160 * 8 * 6 * 16}')
    return conv_macs, deconv_macs


def cnn_bound_ms(macs, bn_elems, dtype, n):
    """The least time of `n` crops' convs (at the bf16 or TF32 peak) and,
    apart, of reading and writing their BN'd activations once in `dtype`
    (at the memory rate)."""
    peak = 989e12 if dtype == torch.bfloat16 else 495e12
    size = 2 if dtype == torch.bfloat16 else 4
    return (2 * macs * n / peak * 1e3,
            2 * size * bn_elems * n / HBM_BYTES_PER_S * 1e3)


def phase_cnn_serve(card, configs=CNN_CONFIGS, label='cnn-serve'):
    """init_pose_model on each (name, config) of `configs` (by default the
    HRNet-W32 (bf16) and ResNet-50 (f32) configs) on the card, seeded
    random weights, TF32 as torch defaults it: one
    8-box call through inference_top_down_pose_model (every tensor on the
    card, keypoints finite and inside their padded boxes; a DeepPose
    model's random coordinates are not bounded, its scores are one), then
    256-crop batches with the flip test and the config's decode: ms per
    batch (median of CNN_SERVE_TURNS) and img/s, the card's busy time per
    batch (torch.profiler), and 0 K1 or K2 launches. A model with window
    attention (HRFormer) also gets window_attention_probe's report."""
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.models.hrformer import WindowMSA
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs
    torch_tf32_defaults()
    rng = np.random.RandomState(3)
    boxes = grid_boxes(rng, 4, 2)
    img = scene(3, boxes)
    persons = [{'bbox': b} for b in boxes]
    n = 256
    big = np.stack([rng.uniform(0, 480, n), rng.uniform(0, 260, n),
                    rng.uniform(60, 160, n), rng.uniform(120, 220, n)],
                   1).astype(np.float32)
    out = {}
    for name, path in configs:
        pm = init_pose_model(path, device='cuda')
        check(all(p.is_cuda for p in pm.model.parameters()),
              f'{label} {name}: a parameter is off the card')
        dtype = next(pm.model.backbone.modules()).dtype
        macs, bn_elems = conv_counts(pm)
        reset_counts()
        results, out_hm = inference_top_down_pose_model(
            pm, img, persons, return_heatmap=True)
        kp = np.stack([r['keypoints'] for r in results])
        check(kp.shape == (8, 17, 3) and np.isfinite(kp).all(),
              f'{label} {name}: keypoints not finite or of shape '
              f'{kp.shape}')
        # random weights leave some heatmaps below 0 everywhere: the
        # decode puts those joints at heatmap cell (-1, -1), as mmpose does;
        # a joint at cell 0 lies on the box edge, up to f32 rounding
        center, size = padded_boxes(boxes, pm)
        inside = np.abs(kp[..., :2] - center[:, None]) \
            <= size[:, None] / 2 + 1e-3
        if pm.cfg.head_type == 'regression':
            check((kp[..., 2] == 1).all(), f'{label} {name}: DeepPose '
                  'scores other than one')
            inside[:] = True
        scored = kp[..., 2] > 0
        bad = [(i, j) for i, j in np.argwhere(scored)
               if not inside[i, j].all()]
        hm = out_hm[0]['heatmap']
        check(not bad and scored.mean() > 0.5,
              f'{label} {name}: {len(bad)} of the {scored.sum()} joints '
              'with a positive score outside their padded boxes: ' + '; '.join(
                  f'box {i} joint {j} at {kp[i, j].tolist()}, box centre '
                  f'{center[i].tolist()} size {size[i].tolist()}, heatmap max '
                  f'{hm[i, j].max()} at {np.unravel_index(hm[i, j].argmax(), hm[i, j].shape)}'
                  for i, j in bad[:3]))
        dev = pm.device
        iw, ih = pm.image_size
        image = torch.from_numpy(img).to(dev)
        c, s = bbox_xywh2cs(boxes[:, :4], iw / ih)
        c, s = c.to(dev), s.to(dev)
        audit = DeviceAudit()
        with audit:
            pm.infer_batch(image[None].expand(8, *image.shape), c, s)
        torch.cuda.synchronize()
        check(not audit.off_device, f'{label} {name}: off-card tensors: '
              f'{sorted(audit.off_device)[:5]}')
        with torch.no_grad():
            feat = pm.model.backbone(torch.zeros(1, ih, iw, 3, device=dev))
        while isinstance(feat, (list, tuple)):      # a multi-stage backbone
            feat = feat[0]
        layout = ('channels_last' if feat.is_contiguous(
            memory_format=torch.channels_last) and not feat.is_contiguous()
            else 'NCHW')
        c, s = bbox_xywh2cs(big, iw / ih)
        c, s = c.to(dev), s.to(dev)
        imgs = image[None].expand(n, *image.shape)
        times = []
        for i in range(CNN_SERVE_TURNS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds, _ = pm.infer_batch(imgs, c, s)
            torch.cuda.synchronize()
            if i:                                        # first is warm-up
                times.append(time.perf_counter() - t0)
            check(torch.isfinite(preds).all().item(),
                  f'{label} {name}: non-finite batch keypoints')
        med = statistics.median(times)
        busy_ms, prof_ms = device_busy_ms(lambda: pm.infer_batch(imgs, c, s))
        k1, k2 = fused_attention.launches, fused_attention_bwd.launches
        check(k1 == 0 and k2 == 0, f'{label} {name}: K1 {k1} and K2 {k2} '
              'launches, expected none')
        conv_ms, bn_ms = cnn_bound_ms(macs, bn_elems, dtype, 2 * n)
        busy = ('not measured' if busy_ms is None else
                f'{busy_ms:.1f} ms busy (idle share '
                f'{1 - busy_ms / prof_ms:.3f} of the profiled {prof_ms:.1f})')
        print(f'{label}: {name} ({path}, {str(dtype)[6:]}, flip test, '
              f'{pm.cfg.post_process} decode, use_udp={pm.cfg.use_udp}): '
              f'8-box call keypoints finite, those of the '
              f'{scored.sum()}/{scored.size} joints with a positive score '
              f'inside their boxes, '
              f'{audit.ops} ops all on CUDA, 0 K1 and 0 K2 launches, '
              f'features {layout}; 256-crop batch median {med * 1e3:.1f} ms '
              f'({min(times) * 1e3:.1f}-{max(times) * 1e3:.1f}) = '
              f'{n / med:.1f} img/s; card {busy}; {macs / 1e9:.3f} GMAC and '
              f'{bn_elems / 1e6:.2f} M BN elements per crop: conv bound '
              f'{conv_ms:.1f} ms, BN read+write bound {bn_ms:.1f} ms per '
              f'batch; on {card}', flush=True)
        out[name] = dict(ms=med * 1e3, img_s=n / med, busy_ms=busy_ms,
                         profiled_ms=prof_ms, gmac_per_crop=macs / 1e9,
                         bn_melems_per_crop=bn_elems / 1e6,
                         conv_bound_ms=conv_ms, bn_bound_ms=bn_ms,
                         layout=layout, k1=k1, k2=k2)
        if any(isinstance(m, WindowMSA) for m in pm.model.modules()):
            out[name]['window_attention'] = window_attention_probe(
                pm, imgs, c, s, med)
        del pm, imgs, image
        torch.cuda.empty_cache()
    return out


def decisive_joints(hm, bound):
    """[N, K] mask of the joints whose argmax (top-2 gap), quarter-pixel
    shift (the neighbour differences at the argmax) and score sign (the
    decode puts a joint whose maximum is not positive at cell (-1, -1)) are
    each more than `bound` from a tie."""
    n, k, h, w = hm.shape
    flat = hm.reshape(n, k, -1)
    top2 = np.sort(flat, axis=-1)[..., -2:]
    idx = flat.argmax(-1)
    y, x = idx // w, idx % w
    rows = np.arange(n)[:, None], np.arange(k)[None, :]
    dx = np.where((x > 0) & (x < w - 1),
                  hm[rows + (y, np.clip(x + 1, 0, w - 1))]
                  - hm[rows + (y, np.clip(x - 1, 0, w - 1))], np.inf)
    dy = np.where((y > 0) & (y < h - 1),
                  hm[rows + (np.clip(y + 1, 0, h - 1), x)]
                  - hm[rows + (np.clip(y - 1, 0, h - 1), x)], np.inf)
    return ((top2[..., 1] - top2[..., 0] > bound) & (np.abs(dx) > bound)
            & (np.abs(dy) > bound) & (np.abs(top2[..., 1]) > bound))


def phase_cnn_ref(card, f32_cases=CNN_CONFIGS,
                  bf16_cases=(('hrnet_w32', HRNET_CFG),), label='cnn-ref',
                  grid=(2, 1)):
    """Each (name, config) of `f32_cases` (by default HRNet-W32 and
    ResNet-50) at full width on a (cols, rows) `grid` of boxes, the same
    seeded weights on CUDA
    and on the CPU: f32 with TF32 off, heatmaps within CNN_HM_RTOL of their
    largest value and decisive keypoints within KP_TOL_PX; those of
    `bf16_cases` (HRNet-W32) also in bf16: CUDA's heatmaps as close to the
    f32 CPU answer as the bf16 CPU path's are (BF16_FACTOR), and every joint
    decoded at a cell whose f32 value is within twice that error of the
    f32 maximum."""
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    boxes = grid_boxes(np.random.RandomState(4), *grid)
    img = scene(4, boxes)
    persons = [{'bbox': b} for b in boxes]
    runs = {}
    cases = [(n, p, 'float32') for n, p in f32_cases] + [
        (n, p, 'bfloat16') for n, p in bf16_cases]
    for name, path, dtype in cases:
        for dev in ('cuda', 'cpu'):
            t0 = time.perf_counter()
            pm = init_pose_model(cnn_model_dict(path, dtype), device=dev)
            res, hm = inference_top_down_pose_model(pm, img, persons,
                                                    return_heatmap=True)
            runs[name, dtype, dev] = (
                np.stack([r['keypoints'][:, :2] for r in res]),
                hm[0]['heatmap'], time.perf_counter() - t0)
            del pm
    report = {}
    for name, _ in f32_cases:
        kp_c, hm_c, s_cuda = runs[name, 'float32', 'cuda']
        kp_r, hm_r, s_cpu = runs[name, 'float32', 'cpu']
        top = np.abs(hm_r).max()
        bound = CNN_HM_RTOL * top
        hm_err = np.abs(hm_c - hm_r).max()
        check(hm_err <= bound, f'{label} {name} f32: CUDA and CPU heatmaps '
              f'differ by {hm_err}, bound {bound}')
        dec = decisive_joints(hm_r, CNN_DECISIVE_BOUNDS * bound)
        check(dec.mean() >= 0.25, f'{label} {name}: only {dec.sum()} of '
              f'{dec.size} joints decisive')
        kp_err = np.abs(kp_c - kp_r).max(-1)[dec].max()
        check(kp_err <= KP_TOL_PX, f'{label} {name} f32: decisive keypoints '
              f'differ by {kp_err} px')
        report[name] = dict(hm_err=float(hm_err), hm_bound=float(bound),
                            kp_err_px=float(kp_err), decisive=int(dec.sum()))
        print(f'{label}: {name} f32 (TF32 off), {len(boxes)} boxes, CUDA vs '
              f'CPU: '
              f'heatmap max abs diff {hm_err:.3e} (bound {bound:.3e} = '
              f'{CNN_HM_RTOL:g} of max |heatmap| {top:.3e}), decisive '
              f'keypoints max diff {kp_err:.3e} px (tol {KP_TOL_PX}) over '
              f'{dec.sum()}/{dec.size} joints; call with model build '
              f'{s_cuda:.1f} s on CUDA, {s_cpu:.1f} s on the CPU', flush=True)
    # bf16: each path's heatmaps against the f32 CPU answer, the CUDA one at
    # most BF16_FACTOR times as far as the CPU one (e). A path within e of
    # the f32 heatmap decodes every joint at a cell whose f32 value is
    # within 2e of the f32 maximum, whatever the ties (random weights make
    # near-ties common): that holds the keypoints' cells
    for name, _ in bf16_cases:
        kp_r, hm_r, _ = runs[name, 'float32', 'cpu']
        errs, short = {}, {}
        flat_r = hm_r.reshape(*hm_r.shape[:2], -1)
        for dev in ('cuda', 'cpu'):
            _, hm, _ = runs[name, 'bfloat16', dev]
            errs[dev] = (np.abs(hm - hm_r).max(),
                         np.sqrt(np.mean((hm - hm_r) ** 2)))
            cells = hm.reshape(*hm.shape[:2], -1).argmax(-1)
            short[dev] = (flat_r.max(-1) - np.take_along_axis(
                flat_r, cells[..., None], -1)[..., 0]).max()
        bound = 2 * BF16_FACTOR * errs['cpu'][0]
        gb, cb = runs[name, 'bfloat16', 'cuda'][1], \
            runs[name, 'bfloat16', 'cpu'][1]
        print(f'{label}: {name} bf16 against the f32 CPU answer, '
              f'{len(boxes)} boxes, '
              f'CUDA / CPU: heatmap max abs {errs["cuda"][0]:.3e} / '
              f'{errs["cpu"][0]:.3e}, RMS {errs["cuda"][1]:.3e} / '
              f'{errs["cpu"][1]:.3e} (CUDA at most {BF16_FACTOR}x CPU); the '
              f'decoded cells fall short of the f32 maximum by at most '
              f'{short["cuda"]:.3e} / {short["cpu"]:.3e} (bound {bound:.3e} = '
              f'2 x {BF16_FACTOR:g} x the CPU error); CUDA vs CPU bf16 '
              f'heatmaps {np.abs(gb - cb).max():.3e}; max |f32 heatmap| '
              f'{np.abs(hm_r).max():.3e}; on {card}', flush=True)
        for i, what in enumerate(('heatmap max', 'heatmap RMS')):
            check(errs['cuda'][i] <= BF16_FACTOR * errs['cpu'][i],
                  f'{label} {name} bf16: CUDA {what} error {errs["cuda"][i]} '
                  f'from the f32 answer, the bf16 CPU path {errs["cpu"][i]}')
        check(max(short.values()) <= bound, f'{label} {name} bf16: decoded '
              f'cells {short} short of the f32 maximum, bound {bound}')
        report[f'{name}_bf16'] = dict(
            hm_err_cuda=float(errs['cuda'][0]),
            hm_err_cpu=float(errs['cpu'][0]),
            hm_rms_cuda=float(errs['cuda'][1]),
            hm_rms_cpu=float(errs['cpu'][1]),
            cell_short_cuda=float(short['cuda']),
            cell_short_cpu=float(short['cpu']), cell_bound=float(bound),
            cuda_vs_cpu_bf16=float(np.abs(gb - cb).max()))
    return report


def phase_cnn_eval(card, path=HRNET_CFG, what='HRNet-W32 bf16',
                   label='cnn-eval', images=CNN_EVAL_IMAGES):
    """The evaluation CLI on a zoo config (by default HRNet-W32, `what`:
    bf16 as it sets it; flip test, the 'default' decode with
    shift_heatmap) over a synthetic COCO
    val set (`images`: small and big ones) and seeded weights saved as a
    .pth: 0 K1 and
    K2 launches, the ten stats, AP in [0, 1]; --int8 raises; then
    run_validation timed: boxes/s, the host's decode alone, the card's busy
    time and idle share."""
    import contextlib
    import io
    import os
    import tempfile
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.eval import COCO_KPT_STAT_NAMES
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.tools import test as cli
    torch_tf32_defaults()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        files, n_boxes = write_eval_set(root, 5, *images)
        pm = init_pose_model(path, device='cuda')
        ckpt = os.path.join(root, 'weights.pth')
        torch.save(pm.model.state_dict(), ckpt)
        del pm
        write_s = time.perf_counter() - t0
        options = eval_options(root, files)
        n_batches = -(-n_boxes // EVAL_BATCH)
        out_json = os.path.join(root, 'stats.json')
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = cli.main([path, ckpt, '--out', out_json,
                              '--cfg-options', *options])
        cli_s = time.perf_counter() - t0
        k1, k2 = fused_attention.launches, fused_attention_bwd.launches
        check(k1 == 0 and k2 == 0, f'{label}: K1 {k1} and K2 {k2} '
              'launches, expected none')
        with open(out_json) as f:
            written = json.load(f)
        check(sorted(written) == sorted(COCO_KPT_STAT_NAMES)
              and written == {k: float(v) for k, v in stats.items()},
              f'{label}: the CLI wrote {written}')
        check(0 <= stats['AP'] <= 1, f'{label}: AP {stats["AP"]}')
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main([path, ckpt, '--int8', '--cfg-options',
                          *options])
            raise Failure(f'{label}: --int8 on a CNN config did not raise')
        except NotImplementedError as e:
            int8_msg = str(e)
        model, ds, loader = eval_objects(options, ckpt, 'cuda',
                                         config=path)
        t0 = time.perf_counter()
        for _ in loader:
            pass
        host_s = time.perf_counter() - t0
        validate(model, loader)                          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = validate(model, loader)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        kp = np.concatenate([r['preds'] for r in results])
        check(kp.shape == (n_boxes, 17, 3) and np.isfinite(kp).all(),
              f'{label}: keypoints not finite or of shape {kp.shape}')
        rescored = ds.evaluate(results)
        drift = max(abs(rescored[k] - stats[k]) for k in stats)
        check(drift <= EVAL_REF_AP_TOL, f'{label}: the timed run scored '
              f'stats {drift} away from the CLI run')
        busy_ms, prof_ms = device_busy_ms(lambda: validate(model, loader))
        idle = (None if busy_ms is None else 1 - busy_ms / prof_ms)
        print(f'{label}: CLI on {path} ({what}, flip test, '
              f'batch {EVAL_BATCH}), {n_boxes} synthetic boxes in '
              f'{n_batches} batches (set and weights written in '
              f'{write_s:.1f} s): 0 K1 and 0 K2 launches; {cli_s:.1f} s with '
              f'model build and checkpoint load; stats ' + ', '.join(
                  f'{k} {v:.4f}' for k, v in stats.items())
              + f' (random weights); --int8 raises ("{int8_msg[:60]}..."); '
              f'run_validation {run_s * 1e3:.1f} ms = {n_boxes / run_s:.1f} '
              f'boxes/s, the host alone {host_s * 1e3:.1f} ms; card busy '
              + ('not measured' if busy_ms is None else
                 f'{busy_ms:.1f} ms of the profiled {prof_ms:.1f} ms, idle '
                 f'share {idle:.3f}') + f'; on {card}', flush=True)
        del model, loader, results
        torch.cuda.empty_cache()
    return dict(boxes=n_boxes, boxes_s=n_boxes / run_s, run_ms=run_s * 1e3,
                host_ms=host_s * 1e3, busy_ms=busy_ms, idle_share=idle,
                ap=stats['AP'], k1=k1, k2=k2)


def cnn_step_ms(path, card):
    """Train steps of `path`'s model at batch TRAIN_BATCH on synthetic
    inputs through the runner's state (build_train_state) and step, the
    config's dtype, target type and losses: (median ms over
    CNN_TIMED_STEPS after one warm-up step, peak GB, kernel ms)."""
    from vitpose_tpu_torch.data.pipeline import make_preprocess_fn
    from vitpose_tpu_torch.train.loop import build_train_state
    from vitpose_tpu_torch.train.step import make_train_step
    from vitpose_tpu_torch.utils.config import load_config
    from vitpose_tpu_torch.data.dataset_info import DatasetInfo
    t_build = time.perf_counter()
    cfg = load_config(path)
    state = build_train_state(cfg, STEPS_PER_EPOCH, 'cuda')
    build_s = time.perf_counter() - t_build
    mcfg = cfg['model']
    target_type = mcfg.get('target_type', 'GaussianHeatmap')
    step = make_train_step(state.model, target_type=target_type,
                           reg_loss=mcfg.get('reg_loss', 'smooth_l1'),
                           heatmap_loss=mcfg.get('heatmap_loss', 'mse'))
    # the config's crop and heatmap sizes (AlexNet's heatmaps are 40x56)
    # and target type (CombinedTarget and DeepPose's paint their own)
    batch = make_preprocess_fn(
        cfg['data']['image_size'], cfg['data']['heatmap_size'],
        use_udp=False, target_type=target_type)(
            *train_inputs(0, TRAIN_BATCH, DatasetInfo.load('coco'), 'cuda'))
    gen = torch.Generator(device='cuda').manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(CNN_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        if i:                                        # first is warm-up
            times.append(time.perf_counter() - t0)
    check(all(np.isfinite(v.item()) for v in m.values()),
          f'cnn-train {path}: non-finite metrics {m}')
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(times)
    t_prof = time.perf_counter()
    busy = profile_steps(lambda: step(state, batch, gen), med, steps=1,
                         label=f'cnn-train {os.path.basename(path)}')
    prof_s = time.perf_counter() - t_prof
    print(f'cnn-train {os.path.basename(path)}: state built in {build_s:.1f} '
          f's, the profiled step and its report {prof_s:.1f} s', flush=True)
    del state, step, batch
    torch.cuda.empty_cache()
    return med * 1e3, peak, busy


def phase_cnn_train(card, path=RES50_CFG, step_configs=CNN_CONFIGS,
                    label='cnn-train', ref_paths=None):
    """The training CLI on a zoo config (by default ResNet-50; TF32 as
    torch defaults it, MSRA targets, batch 64) for one epoch of 2 steps
    over a synthetic COCO set, from seeded weights: 0 K1 and K2 launches,
    finite metrics, the epoch's checkpoint written; step wall time, img/s,
    the data_time share, peak memory. Then the CLI again with --resume for
    a second epoch: it restores epoch 0 and logs 4 finite steps more. Then
    the step of each of `step_configs` at batch 64, and cnn-train-ref on
    the models of `ref_paths` (by default `path`'s)."""
    import os
    import tempfile
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    torch_tf32_defaults()
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, 'train'))
        files, _ = write_eval_set(os.path.join(root, 'train'), 6,
                                  *CNN_TRAIN_IMAGES)
        work_dir = os.path.join(root, 'work')
        options = [f'data.train.ann_file={files["ann"]}',
                   f'data.train.img_prefix={root}/train/',
                   f'data.val.ann_file={files["ann"]}',
                   f'data.val.img_prefix={root}/train/',
                   f'data.val.bbox_file={files["det"]}',
                   'runtime.eval_interval=10', 'runtime.ckpt_interval=1',
                   'runtime.log_interval=1']
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, log = run_train_cli([path, '--work-dir', work_dir,
                                    '--cfg-options', *options,
                                    'optimizer.total_epochs=1'])
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        train = [r for r in log if r['mode'] == 'train']
        check(len(train) == state.step == CNN_CLI_STEPS, f'{label}: '
              f'{len(train)} logged steps, state at {state.step}, expected '
              f'{CNN_CLI_STEPS}')
        check(all(np.isfinite(r[k]) for r in train
                  for k in ('heatmap_loss', 'grad_norm', 'acc_pose')),
              f'{label}: a non-finite training metric')
        check(os.path.exists(os.path.join(work_dir, 'ckpts', 'epoch_0.pth')),
              f'{label}: no epoch checkpoint')
        del state
        t1 = time.perf_counter()
        state, log = run_train_cli([path, '--work-dir', work_dir,
                                    '--resume', '--cfg-options',
                                    *options, 'optimizer.total_epochs=2'])
        later = [r for r in log if r['mode'] == 'train' and r['epoch'] == 1]
        check(any(r['mode'] == 'resume' and r['epoch'] == 1 for r in log)
              and len(later) == CNN_CLI_STEPS
              and state.step == 2 * CNN_CLI_STEPS
              and all(np.isfinite(r['heatmap_loss']) for r in later),
              f'{label}: --resume logged {len(later)} steps of epoch 1, '
              f'state at {state.step}, expected {CNN_CLI_STEPS} and '
              f'{2 * CNN_CLI_STEPS}')
        check(os.path.exists(os.path.join(work_dir, 'ckpts', 'epoch_1.pth')),
              f'{label}: no checkpoint of the resumed epoch')
        resumed = (f'; --resume restored epoch 0 and trained epoch 1 '
                   f'(losses ' + ', '.join(
                       f'{r["heatmap_loss"]:.6f}' for r in later)
                   + f') in {time.perf_counter() - t1:.1f} s')
        del state
        k1, k2 = fused_attention.launches, fused_attention_bwd.launches
        check(k1 == 0 and k2 == 0, f'{label}: K1 {k1} and K2 {k2} '
              'launches, expected none')
        times = step_times(train)
        med = statistics.median(times)
        last = train[-1]
        share = last['data_time'] / last['time']
        torch.cuda.empty_cache()
    print(f'{label}: CLI on {path} (the config\'s dtype, TF32 on for convs, batch '
          f'{TRAIN_BATCH}), {CNN_CLI_STEPS} steps: 0 K1 and 0 K2 launches; '
          f'step wall time median {med * 1e3:.1f} ms '
          f'({min(times) * 1e3:.1f}-{max(times) * 1e3:.1f}) = '
          f'{TRAIN_BATCH / med:.1f} img/s; data_time share '
          f'{share:.3f} ({last["data_time"]:.2f} of {last["time"]:.2f} s); '
          f'losses ' + ', '.join(f'{r["heatmap_loss"]:.6f}' for r in train)
          + f'; whole run {run_s:.1f} s; peak device memory {peak_gb:.2f} '
          f'GB{resumed}; on {card}', flush=True)
    steps = {}
    for name, cfg_path in step_configs:
        ms, peak, busy = cnn_step_ms(cfg_path, card)
        steps[name] = dict(ms=ms, img_s=TRAIN_BATCH / ms * 1e3, peak_gb=peak,
                           kernel_ms=busy)
        print(f'{label}: {name} step (runner state, the config\'s dtype, '
              f'preprocess on the card excluded) at batch {TRAIN_BATCH}: '
              f'median {ms:.1f} ms over {CNN_TIMED_STEPS} = '
              f'{TRAIN_BATCH / ms * 1e3:.1f} img/s, peak {peak:.2f} GB; on '
              f'{card}', flush=True)
    t0 = time.perf_counter()
    ref = {os.path.basename(p): phase_cnn_train_ref(p, f'{label}-ref')
           for p in ref_paths or [path]}
    print(f'{label}: the train-refs took {time.perf_counter() - t0:.1f} s',
          flush=True)
    return dict(cli_ms=med * 1e3, cli_img_s=TRAIN_BATCH / med,
                data_time_share=share, peak_gb=peak_gb, k1=k1, k2=k2,
                steps=steps, ref=ref)


def ref_batch(crop):
    """The train-refs' batch on the CPU: 2 synthetic COCO records through
    the pipeline at `crop` (w, h), heatmaps a quarter of its size."""
    from vitpose_tpu_torch.data.dataset_info import DatasetInfo
    from vitpose_tpu_torch.data.pipeline import make_preprocess_fn
    inputs = train_inputs(1, 2, DatasetInfo.load('coco'), 'cpu')
    return make_preprocess_fn(crop, tuple(v // 4 for v in crop),
                              use_udp=False)(*inputs)


def f64_run_child(path, crop, out):
    """phase_cnn_train_ref's float64 run of `path` at `crop` on
    F64_RUN_THREADS CPU threads, saved to `out` (F64Run's child)."""
    torch.set_num_threads(F64_RUN_THREADS)
    run = train_run(cnn_model_dict(path, 'float64'), 'cpu', ref_batch(crop))
    torch.save(run, out + '.part')
    os.replace(out + '.part', out)


class F64Run:
    """A train-ref's float64 run, started in a child process while other
    phases run: target(*args, out) saves its result to `out` (HRFormer-B's
    f64_run_child: the CPU runs an f64 depthwise conv channel by channel,
    over a minute; PoseWarper's pw_f64_child). result() waits for it and
    returns (run, seconds waited); stop() ends the child and removes its
    files and the `cleanup` directory."""

    def __init__(self, target, args, cleanup=None):
        import multiprocessing
        self.root = tempfile.mkdtemp(prefix='f64run')
        self.cleanup = cleanup
        self.out = os.path.join(self.root, 'run.pt')
        self.proc = multiprocessing.get_context('spawn').Process(
            target=target, args=tuple(args) + (self.out,), daemon=True)
        self.proc.start()

    def result(self):
        t0 = time.perf_counter()
        self.proc.join()
        ok = self.proc.exitcode == 0 and os.path.exists(self.out)
        run = torch.load(self.out) if ok else None
        self.stop()
        check(ok, 'the float64 train-ref run failed in its process (exit '
              f'code {self.proc.exitcode})')
        return run, time.perf_counter() - t0

    def stop(self):
        import shutil
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()
        shutil.rmtree(self.root, ignore_errors=True)
        if self.cleanup:
            shutil.rmtree(self.cleanup, ignore_errors=True)


def phase_cnn_train_ref(path=RES50_CFG, label='cnn-train-ref',
                        crop=(192, 256), f64_run=None):
    """Two steps of `path`'s model (by default ResNet-50) at full width and
    depth, batch 2 of `crop` (w, h) crops (by default the configs'), from the
    same seeded weights (train_run): f32 with TF32 off on CUDA and on the
    CPU, and in float64 on the CPU. Loss, grad_norm, gradients, the
    parameters' and the BN statistics' change of CUDA f32 from the f64 run
    within CNN_REF_FACTOR times the CPU f32's own distance from it plus
    TRAIN_REF_TOL. Parameters whose f64 gradient is below GRAD_NOISE_FLOOR
    of the largest are nought but for rounding (a softmax's shift-free
    logits' bias): they are left out of the distances, and their f32
    gradients must stay below that floor on both devices. An F64Run
    `f64_run` of the same path and crop gives the float64 run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = ref_batch(crop)
    cfg = cnn_model_dict(path, 'float32')
    runs = {dev: train_run(cfg, dev, batch) for dev in ('cuda', 'cpu')}
    if f64_run is None:
        exact = train_run(cnn_model_dict(path, 'float64'), 'cpu', batch)
    else:
        exact, wait_s = f64_run.result()
        print(f'{label}: the float64 run came from its own process '
              f'({F64_RUN_THREADS} CPU threads), waited for {wait_s:.1f} s',
              flush=True)
    report = hold_train_ref(
        label, runs, exact, f'{os.path.basename(path)}, batch 2 of '
        f'{crop[0]}x{crop[1]}')
    torch_tf32_defaults()
    return report


def grad_tops(grads, groups=()):
    """The largest |gradient| that each parameter is measured against: its
    group's (the first of the name prefixes `groups` that it starts with)
    largest, else the largest of the parameters in no group."""
    def group(n):
        return next((g for g in groups if n.startswith(g)), None)
    tops = {}
    for n, g in grads.items():
        tops[group(n)] = max(tops.get(group(n), 0.0), float(g.abs().max()))
    return {n: tops[group(n)] for n in grads}


def hold_train_ref(label, runs, exact, desc, zero_grad=(), zero_floor=None,
                   groups=(), left_out=None):
    """Hold the f32 train_run-layout `runs` on 'cuda' and 'cpu' against
    the float64 run `exact`: parameters whose f64 gradient is below
    GRAD_NOISE_FLOOR of the largest (of their group's largest, for the
    name prefixes `groups`, where separate losses train separate nets) are
    left out of the distances, and their f32 gradients must stay below
    that floor on both devices; the `zero_grad` parameters (a gradient
    nought by the model's structure) are left out too, held below
    `zero_floor` of the largest; every ref_distances metric of CUDA within
    CNN_REF_FACTOR times the CPU's plus TRAIN_REF_TOL. Prints one line
    (`desc` names the model and batch); returns the distances and the
    CUDA per-tensor parameter distances, and adds the names left out to
    the list `left_out` where one is given."""
    tops = grad_tops(exact[1], groups)
    noise = sorted(n for n, g in exact[1].items()
                   if float(g.abs().max()) <= GRAD_NOISE_FLOOR * tops[n]
                   and n not in zero_grad)
    for dev, run in runs.items():
        loud = [n for n in noise if float(run[1][n].abs().max())
                > GRAD_NOISE_FLOOR * tops[n]]
        loud += [n for n in zero_grad
                 if float(run[1][n].abs().max()) > zero_floor * tops[n]]
        check(not loud, f'{label}: {dev} f32 gradients of {loud} exceed '
              'the floor, where the f64 ones are nought')
    left = noise + sorted(zero_grad)
    if left_out is not None:
        left_out.extend(left)
    dist, params = ref_distances(runs['cuda'], exact, left)
    cpu, _ = ref_distances(runs['cpu'], exact, left)
    floors = ', '.join(f'{GRAD_NOISE_FLOOR * t:.3e}'
                       for t in sorted(set(tops.values())))
    print(f'{label}: {desc}, 2 steps, f32 (TF32 off) against f64 '
          f'on the CPU, CUDA / the CPU: '
          + ', '.join(f'{k} {v:.3e} / {cpu[k]:.3e} (tol '
                      f'{CNN_REF_FACTOR:g}x + {TRAIN_REF_TOL[k]:g})'
                      for k, v in dist.items())
          + f'; loss {exact[0]["heatmap_loss"]:.6f}; {len(noise)} of '
          f'{len(exact[1])} parameters with f64 gradients below {floors} '
          f'left out ({", ".join(noise[:4])}'
          f'{", ..." if len(noise) > 4 else ""})'
          + (f' and {len(zero_grad)} whose gradient is nought by structure '
             f'(held below {zero_floor:g} of the largest)' if zero_grad
             else '')
          + f'; largest per-tensor parameter distances on CUDA: '
          f'{worst(params)}', flush=True)
    for k, v in dist.items():
        tol = CNN_REF_FACTOR * cpu[k] + TRAIN_REF_TOL[k]
        check(v <= tol, f'{label}: {k} differs by {v} (tol {tol})')
    return {'cuda_vs_f64': {k: float(v) for k, v in dist.items()},
            'cpu_vs_f64': {k: float(v) for k, v in cpu.items()},
            'noise_only': len(noise), 'noise_only_first': noise[:4],
            'zero_by_structure': len(zero_grad),
            'parameters': len(exact[1])}


def phase_cnn_apps(card):
    """tools/serve.py and tools/export.py on the HRNet-W32 config with
    seeded weights saved as a .pth: 1-box requests answer what the direct
    API call gives, with p50/p99 latency; the export CLI at --batch 8
    --no-flip, its reloaded program against eager within EXPORT_TOL of max
    |eager|, both timed; 0 K1 and K2 launches in either."""
    import base64
    import http.client
    import os
    import tempfile
    import threading
    import cv2
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.tools import export, serve
    torch_tf32_defaults()
    rng = np.random.RandomState(7)
    boxes = grid_boxes(rng, 2, 1)
    img = scene(7, boxes)
    body = json.dumps({'image': base64.b64encode(cv2.imencode(
        '.png', img[..., ::-1])[1].tobytes()).decode(),
        'bboxes': boxes[:1].tolist()}).encode()
    with tempfile.TemporaryDirectory() as root:
        pm = init_pose_model(HRNET_CFG, device='cuda')
        ckpt = os.path.join(root, 'hrnet_w32.pth')
        torch.save(pm.model.state_dict(), ckpt)
        del pm
        reset_counts()
        server = serve.build_server(['--config', HRNET_CFG, '--checkpoint',
                                     ckpt, '--port', '0', '--device',
                                     'cuda'])
        pm = server.pose_model
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]

        def post():
            conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
            try:
                conn.request('POST', '/predict', body=body,
                             headers={'Content-Type': 'application/json'})
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        try:
            status, got = post()
            check(status == 200, f'cnn-apps serve: status {status} {got}')
            direct, _ = inference_top_down_pose_model(
                pm, img, [{'bbox': b} for b in boxes[:1]])
            want = [{'bbox': np.asarray(r['bbox']).tolist(),
                     'keypoints': np.asarray(r['keypoints']).tolist()}
                    for r in direct]
            check(got['pose_results'] == want, 'cnn-apps serve: the response '
                  'differs from the direct call')
            times = []
            for _ in range(CNN_APP_REQUESTS):
                t0 = time.perf_counter()
                status, _ = post()
                times.append((time.perf_counter() - t0) * 1e3)
                check(status == 200, f'cnn-apps serve: status {status}')
        finally:
            server.shutdown()
            server.server_close()
            thread.join(60)
        serve_k = (fused_attention.launches, fused_attention_bwd.launches)
        check(serve_k == (0, 0), f'cnn-apps serve: K1, K2 launched '
              f'{serve_k} times')
        lat = (float(np.percentile(times, 50)), float(np.percentile(times,
                                                                    99)))
        del server, pm
        torch.cuda.empty_cache()

        path = os.path.join(root, 'hrnet_w32_b8.pt2')
        reset_counts()
        t0 = time.perf_counter()
        # without the flip test: half the graph to trace (the ViT export
        # phase exports the flip-tested function)
        program, cli_err = export.main([HRNET_CFG, '--checkpoint', ckpt,
                                        '--out', path, '--batch', '8',
                                        '--no-flip'])
        cli_s = time.perf_counter() - t0
        check('vitpose.attention_fwd' not in program.graph_module.code,
              'cnn-apps export: the HRNet graph holds an attention op')
        pm = init_pose_model(HRNET_CFG, checkpoint=ckpt, device='cuda')
        eager = export.InferModule(pm.model).eval()
        x = torch.randn((8, 256, 192, 3),
                        generator=torch.Generator().manual_seed(1)).cuda()
        run = program.module()
        with torch.no_grad():
            out = run(x)
            ref = eager(x)
            err = (out - ref).abs().max().item()
            bound = EXPORT_TOL * ref.abs().max().item()
            check(torch.isfinite(out).all().item() and err <= bound,
                  f'cnn-apps export: {err} from eager, bound {bound}')
            ms, turns = in_turns(
                {'exported': lambda: wall_ms(lambda: run(x), EXPORT_REPS),
                 'eager': lambda: wall_ms(lambda: eager(x), EXPORT_REPS)})
        export_k = (fused_attention.launches, fused_attention_bwd.launches)
        check(export_k == (0, 0), f'cnn-apps export: K1, K2 launched '
              f'{export_k} times')
        size_mb = os.path.getsize(path) / 1e6
        del program, pm, eager, run
        torch.cuda.empty_cache()
    print(f'cnn-apps: tools/serve.py on {HRNET_CFG}: the 1-box response '
          f'equals the direct call, 0 K1 and 0 K2 launches, latency p50/p99 '
          f'over {CNN_APP_REQUESTS} requests {lat[0]:.1f}/{lat[1]:.1f} ms; '
          f'tools/export.py --batch 8 --no-flip wrote {size_mb:.1f} MB in '
          f'{cli_s:.1f} s (its reload parity {cli_err:.2e}); reloaded '
          f'against eager max abs err {err:.3e} (bound {bound:.3e}), '
          f'exported {ms["exported"]:.2f} / eager {ms["eager"]:.2f} ms per '
          f'call, 0 K1 and 0 K2 launches; on {card}', flush=True)
    return dict(serve_p50_ms=lat[0], serve_p99_ms=lat[1], export_err=err,
                export_bound=bound, exported_ms=ms['exported'],
                eager_ms=ms['eager'], k1=serve_k[0] + export_k[0],
                k2=serve_k[1] + export_k[1])


def cnn_launches(cnn, key, prefix='cnn'):
    """A kernel's launches on each CNN path ('k1' or 'k2') of the `prefix`
    phases' report, for the kernels line's launches_per_path."""
    out = {f'{prefix}_serve': {name: r[key]
                               for name, r in cnn['serve'].items()},
           f'{prefix}_eval': cnn['eval'][key],
           f'{prefix}_train': cnn['train'][key]}
    if 'apps' in cnn:
        out[f'{prefix}_apps'] = cnn['apps'][key]
    return out


def run_phases(tag, phases, card):
    """The (name, phase) pairs in order, each timed and given the card
    line; returns their report, with the seconds of each under
    'phase_s'."""
    report, took = {}, {}
    for name, phase in phases:
        t0 = time.perf_counter()
        report[name] = phase(card)
        took[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    report['phase_s'] = took
    print(f'{tag}: phases took ' + ', '.join(
        f'{k} {v:.1f} s' for k, v in took.items())
        + f' = {sum(took.values()):.1f} s', flush=True)
    return report


def run_cnn_phases(card):
    """The CNN phases in order, each timed; returns their report."""
    return run_phases('cnn', (
        ('serve', phase_cnn_serve), ('ref', phase_cnn_ref),
        ('eval', phase_cnn_eval), ('train', phase_cnn_train),
        ('apps', phase_cnn_apps)), card)


# --- CNN top-down, item 12a: the single-stage backbones --------------------

MORE_CNN_CONFIGS = tuple(
    (name, f'vitpose_tpu/configs/coco/{name}_coco_256x192.py')
    for name in ('resnext50', 'seresnet50', 'seresnext50', 'scnet50',
                 'resnest50', 'vgg16_bn', 'alexnet', 'shufflenetv1',
                 'vipnas_res50', 'vipnas_mbv3'))
MORE_CNN_BF16 = ('resnest50', 'vipnas_mbv3')


def phase_cnn_more_serve(card):
    """count_ops against hand counts of a grouped conv and deconv, then
    phase_cnn_serve on the ten configs."""
    conv_macs, deconv_macs = check_grouped_counts()
    print(f'cnn-more-serve: count_ops equals the hand count of a grouped '
          f'conv ({conv_macs} MACs) and a grouped transposed conv '
          f'({deconv_macs} MACs)', flush=True)
    return phase_cnn_serve(card, MORE_CNN_CONFIGS, 'cnn-more-serve')


def run_cnn_more_phases(card):
    """The item-12a phases in order (serve, ref, train, eval), each timed;
    returns their report."""
    cfgs = dict(MORE_CNN_CONFIGS)
    return run_phases('cnn-more', (
        ('serve', phase_cnn_more_serve),
        ('ref', lambda c: phase_cnn_ref(
            c, MORE_CNN_CONFIGS, [(n, cfgs[n]) for n in MORE_CNN_BF16],
            'cnn-more-ref')),
        ('train', lambda c: phase_cnn_train(
            c, cfgs['vipnas_res50'],
            [(n, p) for n, p in MORE_CNN_CONFIGS if n != 'vipnas_res50'],
            'cnn-more-train')),
        ('eval', lambda c: phase_cnn_eval(
            c, cfgs['vipnas_mbv3'], 'ViPNAS-MobileNetV3 f32',
            'cnn-more-eval'))), card)


# --- CNN top-down, item 12b: the multi-stage and lightweight CNNs ---------

MS_CNN_CONFIGS = tuple(
    (name, f'vitpose_tpu/configs/coco/{name}_coco_{size}.py')
    for name, size in (('mspn50', '256x192'), ('3xrsn50', '256x192'),
                       ('litehrnet_18', '256x192'),
                       ('hourglass52', '256x256'), ('cpm', '256x192'),
                       ('mobilenetv2', '256x192'),
                       ('shufflenetv2', '256x192')))


def run_cnn_ms_phases(card):
    """The item-12b phases in order (serve, ref, train, eval), each timed;
    returns their report."""
    cfgs = dict(MS_CNN_CONFIGS)
    return run_phases('cnn-ms', (
        ('serve', lambda c: phase_cnn_serve(c, MS_CNN_CONFIGS,
                                            'cnn-ms-serve')),
        ('ref', lambda c: phase_cnn_ref(c, MS_CNN_CONFIGS, (),
                                        'cnn-ms-ref')),
        # 3xRSN-50's steps are timed by its training CLI run: the step list
        # leaves it out, as cnn-more's leaves out ViPNAS-ResNet-50
        ('train', lambda c: phase_cnn_train(
            c, cfgs['3xrsn50'], tuple(
                (n, p) for n, p in MS_CNN_CONFIGS if n != '3xrsn50'),
            'cnn-ms-train',
            ref_paths=[cfgs['mspn50'], cfgs['litehrnet_18']])),
        ('eval', lambda c: phase_cnn_eval(
            c, cfgs['mspn50'], "MSPN-50 bf16, the 'megvii' decode",
            'cnn-ms-eval'))), card)


HIGHER_CFG = 'vitpose_tpu/configs/coco/higherhrnet_w32_coco_512x512.py'
HIGHER_UDP_CFG = 'vitpose_tpu/configs/coco/higherhrnet_w32_coco_512x512_udp.py'
AE_HRNET_CFG = 'vitpose_tpu/configs/coco/hrnet_w32_ae_coco_512x512.py'
BU_BASE = 512                        # the configs' input_size
# bu-serve: the first BU_SERVE_IMAGES of 8 image sizes and aspect ratios
# (bu-eval takes all eight)
BU_SERVE_IMAGES = 5
BU_SIZES = ((480, 640), (640, 480), (512, 512), (360, 640), (720, 1280),
            (600, 400), (300, 300), (427, 640))
# random weights put hundreds of local maxima per joint above the parser's
# 0.1 threshold and give every candidate a tag of its own (hundreds of
# people, each refined over maps as large as the image, seconds per
# image): on the phase's images the heatmap biases are shifted so that at
# most about BU_KEEP per joint pass in each, and the tag channels scaled
# to a spread of BU_TAG_STD (the matching joins tags less than 1 apart),
# so that the candidates group into a few people, as trained weights give
BU_KEEP = 3
BU_TAG_STD = 0.1
# bu-ref f32 (TF32 off): maps within this of max |CPU map| (summation order
# through HRNet-W32's convs), grouped poses within BU_POSE_TOL_PX where both
# devices keep the same candidates
BU_MAP_RTOL = 1e-4
BU_POSE_TOL_PX = 1e-2
BU_EVAL_IMAGES = 4
BU_TRAIN_BATCH = 24                  # the flagship config's batch
BU_TRAIN_IMAGES = 2 * BU_TRAIN_BATCH  # 2 steps per epoch
BU_DEMO_K1_PER_FRAME = 24            # 12 ViT blocks x (image, flip)


def bu_scene(seed, hw):
    """A dim random (h, w) image with 2 to 4 bright blobs, textured like
    the rest: a flat patch would give the maps plateaus, every pixel of
    which NMS keeps as a candidate."""
    rng = np.random.RandomState(seed)
    h, w = hw
    img = rng.randint(0, 60, (h, w, 3)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for _ in range(rng.randint(2, 5)):
        cx, cy = rng.uniform(20, w - 20), rng.uniform(20, h - 20)
        img += 190 * np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2)
                            / (2 * 12.0 ** 2))[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


def bu_final_convs(est):
    """The prediction convs whose outputs the maps average (a multi-stage
    head: the last stage's, the head's or, without one, the backbone's)."""
    head = est.keypoint_head
    if est.multi_stage:
        last = head.multi_final_layers[-1]
        return [last if last is not None
                else est.backbone.out_convs[-1].conv]
    return (list(head.final_layers) if hasattr(head, 'final_layers')
            else [head.final_layer])


def bu_model(path, device, imgs=None, shift=None):
    """init_pose_model on the bottom-up config `path` (seeded weights),
    its heatmap biases shifted and its tag channels scaled by `shift` =
    (bias shift, tag scale), or by those that leave at most about BU_KEEP
    local maxima per joint above 0.1 in each of `imgs`' flip-tested maps
    and give the first one's tags a spread of BU_TAG_STD. Returns
    (estimator, shift)."""
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.api.inference import multi_scale_maps
    from vitpose_tpu_torch.ops.group import heatmap_nms
    est = init_pose_model(path, device=device)
    k = est.num_joints
    if shift is None:
        kth, scale = [], None
        for img in imgs:
            hm, tags = multi_scale_maps(est, img, base_size=BU_BASE)[:2]
            top = heatmap_nms(hm).flatten(2).sort(-1, descending=True)[0]
            kth.append(top[0, :, BU_KEEP - 1:BU_KEEP + 1].mean(-1).cpu())
            scale = scale or (BU_TAG_STD / tags.std()).item()
        shift = 0.1 - torch.stack(kth).amax(0), scale
    head, convs = est.keypoint_head, bu_final_convs(est)
    bias, scale = shift
    with torch.no_grad():
        # the heatmaps average the outputs: the last one, which feeds
        # nothing, moves them all
        convs[-1].bias[:k] += len(convs) * bias.to(convs[-1].bias.device)
        # the tags are the first output's; HigherHRNet's deconv takes that
        # output too, so its weight for the tag channels undoes the scale
        convs[0].weight[k:] *= scale
        convs[0].bias[k:] *= scale
        if hasattr(head, 'final_layers') and head.cat_output[0]:
            deconv = head.deconv_layers[0][0][0]
            deconv.weight[-(convs[0].out_channels - k):] /= scale
    return est, shift


def bu_timed(run):
    """run() (bottom-up API calls, or the CLI that makes them) timed in two
    halves: the host's grouping (`group_bottom_up`, which each API call
    makes last; wrapped here, after a synchronize) and the rest (resize on
    the host, forward + flip + aggregation on the card). Returns (run()'s
    result, the rest's s, grouping s)."""
    from vitpose_tpu_torch.api import inference
    group, spent = inference.group_bottom_up, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = group(*a, **k)
        spent.append(time.perf_counter() - t0)
        return out

    inference.group_bottom_up = timed
    try:
        t0 = time.perf_counter()
        out = run()
        total = time.perf_counter() - t0
    finally:
        inference.group_bottom_up = group
    return out, total - sum(spent), sum(spent)


def bu_grouping_profile(est, img):
    """cProfile of the host half of one multi-scale call on `img`: the
    functions that take the most of it, (name, s) by own time."""
    import cProfile
    import pstats
    from vitpose_tpu_torch.api.inference import (group_bottom_up,
                                                 multi_scale_maps)
    maps = multi_scale_maps(est, img, base_size=BU_BASE)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    group_bottom_up(est, *maps, est.dataset_info)
    prof.disable()
    st = pstats.Stats(prof).stats
    top = sorted(st.items(), key=lambda kv: -kv[1][2])[:6]
    rows = [(f'{os.path.basename(f)}:{n}' if f != '~' else n, tt)
            for (f, _, n), (_, _, tt, _, _) in top]
    total = sum(v[2] for v in st.values())
    print(f'bu-serve: grouping of one {img.shape[1]}x{img.shape[0]} image '
          f'(maps {tuple(maps[0].shape[2:])}) by cProfile, {total * 1e3:.1f} '
          'ms: ' + '; '.join(f'{n} {t * 1e3:.1f} ms' for n, t in rows),
          flush=True)
    return rows


def check_poses(what, results):
    kp = [r['keypoints'] for res in results for r in res]
    check(kp and all(k.shape == (17, 3) and np.isfinite(k).all() for k in kp)
          and all(np.isfinite(r['score']) for res in results for r in res),
          f'{what}: {len(kp)} poses, not all finite [17, 3]')
    return len(kp)


def phase_bu_serve(card):
    """HigherHRNet-W32 512 (f32, TF32 as torch defaults it, seeded weights)
    through init_pose_model, inference_bottom_up_multi_scale and
    inference_bottom_up_pose_model over BU_SERVE_IMAGES images of mixed
    sizes: every
    parameter and every tensor of the forward + flip + reduction on the
    card, finite poses, 0 K1 and K2 launches; each image's device half
    (resize, forward, flip, aggregation) and host half (grouping) timed
    apart, images/s, and the card's busy time over 2 of the images."""
    from vitpose_tpu_torch.api import (inference_bottom_up_multi_scale,
                                       inference_bottom_up_pose_model)
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    torch_tf32_defaults()
    imgs = [bu_scene(20 + i, hw) for i, hw in enumerate(
        BU_SIZES[:BU_SERVE_IMAGES])]
    t0 = time.perf_counter()
    est, _ = bu_model(HIGHER_CFG, 'cuda', imgs)
    build_s = time.perf_counter() - t0
    check(all(p.is_cuda for p in est.parameters()), 'bu-serve: a parameter '
          'is off the card')
    reset_counts()
    apis = {'multi_scale': inference_bottom_up_multi_scale,
            'single': inference_bottom_up_pose_model}
    x = torch.randn(1, BU_BASE, BU_BASE, 3, device='cuda')
    flip = torch.tensor(est.dataset_info.flip_index, device='cuda')
    audit = DeviceAudit()
    with audit:
        est.infer(x, flip)
    torch.cuda.synchronize()
    check(not audit.off_device, f'bu-serve: off-card tensors: '
          f'{sorted(audit.off_device)[:5]}')
    out = {}
    for name, api in apis.items():
        api(est, imgs[0], base_size=BU_BASE)               # warm-up
        results, t_maps, t_group = bu_timed(
            lambda: [api(est, im, base_size=BU_BASE)[0] for im in imgs])
        poses = check_poses(f'bu-serve {name}', results)
        n = len(imgs)
        busy_ms, prof_ms = device_busy_ms(
            lambda: [api(est, im, base_size=BU_BASE) for im in imgs[:2]])
        idle = None if busy_ms is None else 1 - busy_ms / prof_ms
        out[name] = dict(img_s=n / (t_maps + t_group),
                         device_half_ms=t_maps / n * 1e3,
                         host_grouping_ms=t_group / n * 1e3,
                         busy_ms=busy_ms, profiled_ms=prof_ms,
                         idle_share=idle, poses=poses)
        print(f'bu-serve: {name} ({HIGHER_CFG}, HigherHRNet-W32 f32, flip, '
              f'{len(imgs)} images of {len(imgs)} sizes): {poses} finite '
              f'poses; per image {t_maps / n * 1e3:.1f} ms resize + forward '
              f'+ flip + aggregation (card) and {t_group / n * 1e3:.1f} ms '
              f'grouping (host) = {n / (t_maps + t_group):.2f} img/s; card '
              'busy over 2 of the images ' + (
                  'not measured' if busy_ms is None else
                  f'{busy_ms:.1f} ms of {prof_ms:.1f} ms, idle share '
                  f'{idle:.3f}') + f'; on {card}', flush=True)
    k1, k2 = fused_attention.launches, fused_attention_bwd.launches
    check(k1 == 0 and k2 == 0, f'bu-serve: K1 {k1} and K2 {k2} launches, '
          'expected none')
    out['grouping_top'] = bu_grouping_profile(est, imgs[4])
    print(f'bu-serve: model build {build_s:.1f} s, every tensor of the '
          f'forward + flip + reduction on CUDA ({audit.ops} ops), 0 K1 and '
          f'0 K2 launches', flush=True)
    del est
    torch.cuda.empty_cache()
    out.update(k1=k1, k2=k2)
    return out


BU_REF_CASES = (('higherhrnet_w32', HIGHER_CFG),
                ('higherhrnet_w32_udp', HIGHER_UDP_CFG),
                ('hrnet_w32_ae', AE_HRNET_CFG))


def phase_bu_ref(card, cases=BU_REF_CASES, label='bu-ref'):
    """The (name, config) `cases`, by default the flagship, its UDP twin and
    the HRNet-W32 AE simple head, at full width, the same seeded (and
    shifted) weights on CUDA and on the CPU, f32
    with TF32 off, the first case on a landscape and a portrait image, the
    others on one of them each in turns, through the multi-scale protocol:
    the
    aggregated heatmaps and tags within BU_MAP_RTOL of their largest value;
    where both devices keep the same candidates (the parser's top values
    and cells per joint), the grouped poses within BU_POSE_TOL_PX; the
    images where they do not are counted."""
    import copy
    from vitpose_tpu_torch.api.inference import (group_bottom_up,
                                                 multi_scale_maps)
    from vitpose_tpu_torch.ops.group import topk_candidates
    from vitpose_tpu_torch.utils.config import load_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scenes = [bu_scene(40, (480, 640)), bu_scene(41, (640, 427))]
    report = {}
    for ci, (name, path) in enumerate(cases):
        # the first case (the flagship) on both images, the others on one
        # each, the landscape and the portrait one in turns
        imgs = scenes if ci == 0 else [scenes[ci % len(scenes)]]
        use_udp = load_config(path)['data'].get('use_udp', False)
        t0 = time.perf_counter()
        ests = {}
        ests['cuda'], _ = bu_model(path, 'cuda', imgs)
        ests['cpu'] = copy.deepcopy(ests['cuda']).cpu()
        errs, pose_err, differ, poses = [0.0, 0.0], 0.0, 0, 0
        for img in imgs:
            maps = {d: multi_scale_maps(e, img, base_size=BU_BASE,
                                        use_udp=use_udp)
                    for d, e in ests.items()}
            for i in range(2):
                ref = maps['cpu'][i]
                err = (maps['cuda'][i].cpu() - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                errs[i] = max(errs[i], rel)
                check(rel <= BU_MAP_RTOL, f'{label} {name}: CUDA and CPU '
                      f'{("heatmaps", "tags")[i]} differ by {err} '
                      f'({rel:.2e} of the largest), bound {BU_MAP_RTOL}')
            thr = ests['cpu'].parser.detection_threshold
            kept = {}
            for d, m in maps.items():
                c = topk_candidates(m[0], m[1],
                                    ests[d].parser.max_num_people)
                above = c['val_k'].cpu() > thr
                kept[d] = (above, c['loc_k'].cpu()[above])
            same = all(torch.equal(a, b) for a, b in zip(kept['cuda'],
                                                          kept['cpu']))
            res = {d: group_bottom_up(ests[d], *maps[d], None, use_udp, None)
                   for d in maps}
            if not same or len(res['cuda']) != len(res['cpu']):
                differ += 1
                continue
            poses += len(res['cpu'])
            for a, b in zip(res['cuda'], res['cpu']):
                pose_err = max(pose_err, float(np.abs(
                    a['keypoints'][:, :2] - b['keypoints'][:, :2]).max()))
        check(pose_err <= BU_POSE_TOL_PX, f'{label} {name}: grouped poses '
              f'differ by {pose_err} px where the candidates agree')
        check(poses > 0 or differ == len(imgs), f'{label} {name}: no poses')
        report[name] = dict(heatmap_rel_err=errs[0], tag_rel_err=errs[1],
                            pose_err_px=pose_err, images_differ=differ,
                            poses_compared=poses)
        print(f'{label}: {name} ({path}, f32, TF32 off), {len(imgs)} '
              f'images, CUDA vs '
              f'CPU: heatmaps {errs[0]:.2e} and tags {errs[1]:.2e} of their '
              f'largest value apart (bound {BU_MAP_RTOL:g}); the same '
              f'candidates on {len(imgs) - differ} of {len(imgs)} images, '
              f'where the {poses} grouped poses lie within {pose_err:.2e} px '
              f'(tol {BU_POSE_TOL_PX}); {time.perf_counter() - t0:.1f} s '
              f'with the model build', flush=True)
        del ests
        torch.cuda.empty_cache()
    torch_tf32_defaults()
    return report


def bu_people(rng, h, w, n):
    """n seeded people, each 17 joints around a centre, COCO visibilities."""
    out = []
    for _ in range(n):
        c = np.array([rng.uniform(40, w - 40), rng.uniform(60, h - 60)])
        kp = c + rng.normal(0, [20, 40], (17, 2))
        out.append(np.concatenate([kp, np.where(
            rng.rand(17, 1) < 0.85, 2, 0)], 1))
    return out


def write_bu_set(root, seed, n, people_of):
    """n JPEGs of mixed sizes in root/img and a COCO keypoint json:
    people_of(i, img) -> [[17, 3] keypoints]; image 0 also gets a crowd
    region in compressed RLE and image 1 one in polygons. Returns (json
    path, image prefix, the images)."""
    import cv2
    from vitpose_tpu_torch.data.mask import encode_compressed_rle, mask_to_rle
    prefix = os.path.join(root, 'img')
    os.makedirs(prefix, exist_ok=True)
    images, anns, arrays = [], [], []
    for i in range(n):
        hw = BU_SIZES[i % len(BU_SIZES)]
        img = bu_scene(seed + i, hw)
        name = f'{i + 1:012d}.jpg'
        cv2.imwrite(os.path.join(prefix, name), img[..., ::-1])
        images.append(dict(id=i + 1, file_name=name, width=hw[1],
                           height=hw[0]))
        arrays.append(img)
        for kp in people_of(i, img):
            x0, y0 = kp[:, :2].min(0)
            x1, y1 = kp[:, :2].max(0)
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=1, iscrowd=0,
                bbox=[float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                area=float(max((x1 - x0) * (y1 - y0), 1.0)),
                keypoints=np.asarray(kp, np.float64).ravel().tolist(),
                num_keypoints=int((kp[:, 2] > 0).sum())))
        if i < 2:
            h, w = hw
            m = np.zeros((h, w), np.uint8)
            m[10:90, 20:140] = 1
            segm = (dict(counts=encode_compressed_rle(
                mask_to_rle(m)['counts']), size=[h, w]) if i == 0 else
                [[200.0, 100.0, 300.0, 100.0, 300.0, 220.0, 200.0, 220.0]])
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=1, iscrowd=1, keypoints=[0] * 51,
                             num_keypoints=0, bbox=[20, 10, 120, 80],
                             area=9600.0, segmentation=segm))
    path = os.path.join(root, 'ann.json')
    with open(path, 'w') as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), f)
    return path, prefix + '/', arrays


def phase_bu_eval(card):
    """The evaluation CLI on the flagship config over a synthetic COCO set
    of BU_EVAL_IMAGES images (a crowd region in compressed RLE and one in
    polygons) whose GT people are the seeded model's own poses on the same
    images, jittered, so that AP lies in (0, 1]; the weights saved as a
    .pth: 0 K1 and K2 launches, the stats, the CLI's img/s with the card's
    half apart from the host's grouping; the same per-image work through
    the API on the raw images, and the card's idle share over 4 of them."""
    import io
    import tempfile
    from vitpose_tpu_torch.api import inference_bottom_up_multi_scale as api
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.tools import test as cli
    torch_tf32_defaults()
    imgs = [bu_scene(300 + i, BU_SIZES[i % len(BU_SIZES)])
            for i in range(BU_EVAL_IMAGES)]
    n = len(imgs)
    with tempfile.TemporaryDirectory() as root:
        est, _ = bu_model(HIGHER_CFG, 'cuda', imgs)
        api(est, imgs[0], base_size=BU_BASE)                 # warm-up
        poses, t_maps, t_group = bu_timed(
            lambda: [api(est, im, base_size=BU_BASE, pose_nms_thr=None)[0]
                     for im in imgs])
        rng = np.random.RandomState(31)

        def jittered(i, img):
            out = []
            for r in poses[i][:4]:
                kp = r['keypoints'].astype(np.float64)
                kp[:, :2] += rng.normal(0, 2.0, (17, 2))
                kp[:, 2] = np.where(rng.rand(17) < 0.8, 2, 0)
                out.append(kp)
            return out

        ann, prefix, _ = write_bu_set(root, 300, n, jittered)
        ckpt = os.path.join(root, 'higherhrnet_w32.pth')
        torch.save(est.state_dict(), ckpt)
        busy_ms, prof_ms = device_busy_ms(
            lambda: [api(est, im, base_size=BU_BASE) for im in imgs[:4]])
        idle = None if busy_ms is None else 1 - busy_ms / prof_ms
        del est
        torch.cuda.empty_cache()
        options = [f'data.val.ann_file={ann}', f'data.val.img_prefix={prefix}']
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            stats, cli_rest, cli_group = bu_timed(lambda: cli.main(
                [HIGHER_CFG, ckpt, '--cfg-options', *options]))
        cli_s = cli_rest + cli_group
        k1, k2 = fused_attention.launches, fused_attention_bwd.launches
        check(k1 == 0 and k2 == 0, f'bu-eval: K1 {k1} and K2 {k2} launches, '
              'expected none')
        check(0 < stats['AP'] <= 1, f'bu-eval: AP {stats["AP"]}')
    print(f'bu-eval: CLI on {HIGHER_CFG} (HigherHRNet-W32 f32, scale 1 + '
          f'flip, grouping), {n} synthetic JPEGs of {len(set(BU_SIZES))} '
          f'sizes, GT from the seeded model\'s own poses jittered: 0 K1 and '
          f'0 K2 launches; stats ' + ', '.join(
              f'{k} {v:.4f}' for k, v in stats.items())
          + f'; {cli_s:.1f} s = {n / cli_s:.2f} img/s with model build, '
          f'checkpoint load, JPEG decode and scoring, {cli_group:.1f} s of '
          f'it grouping (host); the API alone on the raw images '
          f'{n / (t_maps + t_group):.2f} img/s: {t_maps / n * 1e3:.1f} ms '
          f'resize + forward + flip + aggregation (card) and '
          f'{t_group / n * 1e3:.1f} ms grouping (host) per image; card busy '
          'over 4 of the images ' + (
              'not measured' if busy_ms is None else
              f'{busy_ms:.1f} ms of {prof_ms:.1f} ms, idle share '
              f'{idle:.3f}') + f'; on {card}', flush=True)
    return dict(images=n, ap=stats['AP'], cli_s=cli_s,
                cli_grouping_s=cli_group, img_s=n / (t_maps + t_group),
                device_half_ms=t_maps / n * 1e3,
                host_grouping_ms=t_group / n * 1e3, busy_ms=busy_ms,
                idle_share=idle, k1=k1, k2=k2)


def bu_step_profile(state, batch, step_s, card):
    """One profiled train step: kernel time, CUDA kernel launches and the
    idle share against the median step."""
    from torch.profiler import ProfilerActivity, profile
    from vitpose_tpu_torch.train.bottomup_loop import make_bottomup_train_step
    step = make_bottomup_train_step(state.model)
    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    kernels = kernel_totals(device_kernels(prof))
    busy = sum(ms for _, ms, _ in kernels)
    launches = sum(c for _, _, c in kernels)
    if busy == 0:
        return None, None
    top = kernels[:5]
    print(f'bu-train: profiler, 1 step at batch {BU_TRAIN_BATCH}: kernels '
          f'busy {busy:.1f} ms of the {step_s * 1e3:.1f} ms median CLI step '
          f'(idle share {1 - busy / (step_s * 1e3):.3f}), {launches} kernel '
          f'launches; top: ' + '; '.join(
              f'{name[:60]} {ms:.2f} ms x{count}'
              for name, ms, count in top) + f'; on {card}', flush=True)
    return busy, launches


def phase_bu_train(card):
    """The training CLI on the flagship config at its batch of 24, 512
    input, output sizes (128, 256), over a synthetic COCO set of 48 images
    (2 steps per epoch; crowd regions in RLE and polygons), seeded weights:
    2 epochs in one run; --resume from its epoch-0 checkpoint (in a copy of
    the work dir without epoch 1's) redoes the second and equals it bit for
    bit (parameters, BN statistics, Adam's moments; cuDNN deterministic for
    these runs); 0 K1 and K2 launches, finite losses;
    step wall time and img/s, the data_time share, peak memory, and one
    profiled step's kernel time and launches."""
    import shutil
    import tempfile
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.train.bottomup_loop import (batch_to_device,
                                                       build_bottomup_loader)
    from vitpose_tpu_torch.utils.config import apply_options, load_config
    torch_tf32_defaults()
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as root:
            rng = np.random.RandomState(50)
            ann, prefix, _ = write_bu_set(
                root, 500, BU_TRAIN_IMAGES,
                lambda i, img: bu_people(rng, *img.shape[:2],
                                         rng.randint(1, 5)))
            options = [f'data.train.ann_file={ann}',
                       f'data.train.img_prefix={prefix}',
                       'runtime.log_interval=1']
            runs = {}
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            work = os.path.join(root, 'whole')
            args = [HIGHER_CFG, '--work-dir', work, '--cfg-options',
                    *options, 'optimizer.total_epochs=2']
            t0 = time.perf_counter()
            runs['whole'] = (*run_train_cli(args), time.perf_counter() - t0)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            # epoch 1 again from the epoch-0 checkpoint, in a copy of the
            # work dir without epoch 1's (the first epoch runs once)
            cut = os.path.join(root, 'cut')
            shutil.copytree(work, cut)
            for name in ('epoch_1.pth', 'info_1.json'):
                os.remove(os.path.join(cut, 'ckpts', name))
            args[args.index(work)] = cut
            resumed, rlog = run_train_cli([args[0], '--resume', *args[1:]])
            rlog = rlog[len(runs['whole'][1]):]
            k1, k2 = fused_attention.launches, fused_attention_bwd.launches
            check(k1 == 0 and k2 == 0, f'bu-train: K1 {k1} and K2 {k2} '
                  'launches, expected none')
            whole, log, whole_s = runs['whole']
            train = [r for r in log if r['mode'] == 'train']
            check(len(train) == whole.step == resumed.step == 4,
                  f'bu-train: {len(train)} logged steps, states at '
                  f'{whole.step} and {resumed.step}, expected 4')
            check(all(np.isfinite(r[k]) for r in train for k in (
                'heatmap_loss', 'push_loss', 'pull_loss', 'grad_norm')),
                'bu-train: a non-finite training metric')
            a, b = whole.model.state_dict(), resumed.model.state_dict()
            same = [k for k in a if not torch.equal(a[k], b[k])]
            oa, ob = whole.optimizer.state_dict(), \
                resumed.optimizer.state_dict()
            moments = [(i, k) for i in oa['state'] for k in ('exp_avg',
                                                           'exp_avg_sq')
                       if not torch.equal(oa['state'][i][k],
                                          ob['state'][i][k])]
            check(not same and not moments, f'bu-train: the resumed run '
                  f'differs from the uninterrupted one in {len(same)} '
                  f'tensors ({same[:3]}) and {len(moments)} Adam moments')
            rtrain = [r for r in rlog if r['mode'] == 'train'
                      and r['epoch'] == 1]
            check([r['total_loss'] for r in rtrain] == [
                r['total_loss'] for r in train if r['epoch'] == 1],
                'bu-train: the resumed epoch logged other losses')
            times = step_times(log)
            med = statistics.median(times)
            share = train[-1]['data_time'] / train[-1]['time']
            cfg = apply_options(load_config(HIGHER_CFG), options)
            batch = batch_to_device(next(iter(build_bottomup_loader(cfg))),
                                    'cuda')
            busy, launches = bu_step_profile(whole, batch, med, card)
            del whole, resumed, runs, batch
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    print(f'bu-train: CLI on {HIGHER_CFG} (HigherHRNet-W32 f32, TF32 on for '
          f'convs, batch {BU_TRAIN_BATCH}, 512 -> (128, 256)), 2 epochs of 2 '
          f'steps: 0 K1 and 0 K2 launches; epoch 1 redone with --resume from '
          f'the epoch-0 checkpoint equals the uninterrupted one bit for bit '
          f'(every '
          f'parameter, BN statistic and Adam moment); step wall time median '
          f'{med * 1e3:.1f} ms ({min(times) * 1e3:.1f}-'
          f'{max(times) * 1e3:.1f}) = {BU_TRAIN_BATCH / med:.1f} img/s; '
          f'data_time share {share:.3f}; losses ' + ', '.join(
              f'{r["total_loss"]:.4f}' for r in train)
          + f'; whole run {whole_s:.1f} s; peak device memory {peak_gb:.2f} '
          f'GB; on {card}', flush=True)
    return dict(step_ms=med * 1e3, img_s=BU_TRAIN_BATCH / med,
                data_time_share=share, peak_gb=peak_gb, kernel_ms=busy,
                kernel_launches_per_step=launches, k1=k1, k2=k2)


def phase_bu_apps(card):
    """The three bottom-up demos (ViT-S f32 at base 256 with K1, as JAX's
    build_estimator) on the card: the image demo on a 480x640 scene and the
    video and tracking demos on a 4-frame MJPG video of it: every output
    written, videos read back frame for frame, exactly BU_DEMO_K1_PER_FRAME
    K1 launches per frame and image, at shapes KERNEL_CASES holds, and no
    K2 in any demo;
    frames/s over each main()."""
    import io
    import tempfile
    from vitpose_tpu_torch.demo import (bottom_up_img_demo,
                                        bottom_up_pose_tracking_demo,
                                        bottom_up_video_demo)
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    import cv2
    img = bu_scene(60, (480, 640))
    fps, k1, k2 = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, 'scene.jpg')
        cv2.imwrite(path, img[..., ::-1])
        video = write_video(os.path.join(root, 'scene.avi'), img,
                            DEMO_FRAMES)
        reset_counts()
        for name, demo, args, frames in (
                ('bottom_up_img_demo', bottom_up_img_demo,
                 [path, '--out-img-root', root], 1),
                ('bottom_up_video_demo', bottom_up_video_demo,
                 [video, '--out-video-root', root], DEMO_FRAMES),
                ('bottom_up_pose_tracking_demo',
                 bottom_up_pose_tracking_demo,
                 [video, '--out-video-root', root], DEMO_FRAMES)):
            before = fused_attention.launches
            before_bwd = fused_attention_bwd.launches
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                out = demo.main(args)
            secs = time.perf_counter() - t0
            launches = fused_attention.launches - before
            launches_bwd = fused_attention_bwd.launches - before_bwd
            check(launches_bwd == 0,
                  f'bu-apps {name}: {launches_bwd} K2 launches')
            check(launches == BU_DEMO_K1_PER_FRAME * frames,
                  f'bu-apps {name}: {launches} K1 launches over {frames} '
                  f'frames, expected {BU_DEMO_K1_PER_FRAME} per frame')
            written = out[1]
            check(os.path.exists(written), f'bu-apps {name}: no output')
            if frames > 1:
                check(out[0] == frames and count_frames(written) == frames,
                      f'bu-apps {name}: {out[0]} frames, read back '
                      f'{count_frames(written)}')
            fps[name] = frames / secs
            k1[name] = launches / frames
            k2[name] = launches_bwd / frames
        check_shapes_held('bu-apps')
    print(f'bu-apps: the 3 bottom-up demos (ViT-S f32, base 256, K1) on the '
          f'card: {BU_DEMO_K1_PER_FRAME} K1 launches per frame, all at held '
          f'shapes, outputs written and read back; frames/s (model build '
          f'included) ' + ', '.join(f'{k} {v:.2f}' for k, v in fps.items())
          + f'; on {card}', flush=True)
    return dict(frames_per_s=fps, k1_per_frame=k1, k2_per_frame=k2)


def run_bu_phases(card):
    """The bottom-up phases in order, each timed; returns their report."""
    return run_phases('bu', (
        ('serve', phase_bu_serve), ('ref', phase_bu_ref),
        ('eval', phase_bu_eval), ('train', phase_bu_train),
        ('apps', phase_bu_apps)), card)


# --- bottom-up, item 12b: Hourglass-AE and MobileNetV2-AE -------------------

HG_AE_CFG = 'vitpose_tpu/configs/coco/hourglass_ae_coco_512x512.py'
MBV2_AE_CFG = 'vitpose_tpu/configs/coco/mobilenetv2_ae_coco_512x512.py'
BU_MS_CONFIGS = (('hourglass_ae', HG_AE_CFG), ('mobilenetv2_ae', MBV2_AE_CFG))
BU_MS_IMAGES = 2                     # of BU_SIZES' first two sizes


def phase_bu_ms(card):
    """Hourglass-AE (4 stacks) and MobileNetV2-AE (the AE simple head) at
    full width, f32 as their configs set it, seeded and shifted weights:
    both API functions on BU_MS_IMAGES images of different sizes on the
    card (every tensor of the forward + flip + reduction on CUDA, finite
    poses, 0 K1 and K2 launches, the stages the model gives and the one the
    test protocol keeps, each image's card and host halves timed apart);
    CUDA against the CPU as phase_bu_ref; one training step at
    the config's batch over a synthetic set through the config's loader,
    losses finite and every BN's running statistics moved."""
    from vitpose_tpu_torch.api import (inference_bottom_up_multi_scale,
                                       inference_bottom_up_pose_model)
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    torch_tf32_defaults()
    imgs = [bu_scene(70 + i, hw) for i, hw in enumerate(
        BU_SIZES[:BU_MS_IMAGES])]
    apis = {'multi_scale': inference_bottom_up_multi_scale,
            'single': inference_bottom_up_pose_model}
    out = {}
    for name, path in BU_MS_CONFIGS:
        t0 = time.perf_counter()
        est, _ = bu_model(path, 'cuda', imgs[:2])
        build_s = time.perf_counter() - t0
        check(all(p.is_cuda for p in est.parameters()),
              f'bu-ms {name}: a parameter is off the card')
        x = torch.randn(1, BU_BASE, BU_BASE, 3, device='cuda')
        with torch.no_grad():
            stages = len(est(x))
        kept = 1 if est.multi_stage else stages
        flip = torch.tensor(est.dataset_info.flip_index, device='cuda')
        reset_counts()
        audit = DeviceAudit()
        with audit:
            est.infer(x, flip)
        torch.cuda.synchronize()
        check(not audit.off_device, f'bu-ms {name}: off-card tensors: '
              f'{sorted(audit.off_device)[:5]}')
        rows = {}
        for api_name, api in apis.items():
            api(est, imgs[0], base_size=BU_BASE)             # warm-up
            results, t_maps, t_group = bu_timed(
                lambda: [api(est, im, base_size=BU_BASE)[0] for im in imgs])
            n = len(imgs)
            rows[api_name] = dict(
                poses=check_poses(f'bu-ms {name} {api_name}', results),
                device_half_ms=t_maps / n * 1e3,
                host_grouping_ms=t_group / n * 1e3,
                img_s=n / (t_maps + t_group))
        busy_ms, prof_ms = device_busy_ms(
            lambda: [inference_bottom_up_multi_scale(est, im,
                                                     base_size=BU_BASE)
                     for im in imgs[:2]])
        k1, k2 = fused_attention.launches, fused_attention_bwd.launches
        check(k1 == 0 and k2 == 0, f'bu-ms {name}: K1 {k1} and K2 {k2} '
              'launches, expected none')
        idle = None if busy_ms is None else 1 - busy_ms / prof_ms
        print(f'bu-ms: {name} ({path}, f32, base {BU_BASE}, flip, '
              f'{len(imgs)} images of {len(imgs)} sizes): the model gives '
              f'{stages} output(s), the test protocol keeps {kept}; every '
              f'tensor of the forward + flip + reduction on CUDA '
              f'({audit.ops} ops), 0 K1 and 0 K2 launches; ' + '; '.join(
                  f'{a}: {r["poses"]} finite poses, per image '
                  f'{r["device_half_ms"]:.1f} ms card half and '
                  f'{r["host_grouping_ms"]:.1f} ms host grouping = '
                  f'{r["img_s"]:.2f} img/s' for a, r in rows.items())
              + '; card busy over 2 multi-scale calls ' + (
                  'not measured' if busy_ms is None else
                  f'{busy_ms:.1f} ms of {prof_ms:.1f} ms, idle share '
                  f'{idle:.3f}') + f'; model build {build_s:.1f} s; on '
              f'{card}', flush=True)
        out[name] = dict(stages=stages, kept=kept, busy_ms=busy_ms,
                         idle_share=idle, k1=k1, k2=k2, **rows)
        del est
        torch.cuda.empty_cache()
    out['ref'] = phase_bu_ref(card, BU_MS_CONFIGS, 'bu-ms-ref')
    out['train'] = {name: bu_ms_train_step(path, name, card)
                    for name, path in BU_MS_CONFIGS}
    return out


def bu_ms_train_step(path, name, card):
    """One training step (then a timed second) of `path`'s estimator at the
    config's batch over a synthetic set through the config's loader and the
    runner's state and step: finite losses, every BN's running statistics
    moved, 0 K1 and K2 launches; (step ms, peak GB, losses)."""
    import tempfile
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.train.bottomup_loop import (
        batch_to_device, bottomup_train_state, build_bottomup_loader,
        make_bottomup_train_step)
    from vitpose_tpu_torch.utils.config import apply_options, load_config
    torch_tf32_defaults()
    with tempfile.TemporaryDirectory() as root:
        cfg = load_config(path)
        n = cfg['data']['batch_size']
        rng = np.random.RandomState(80)
        ann, prefix, _ = write_bu_set(
            root, 800, n, lambda i, img: bu_people(rng, *img.shape[:2],
                                                   rng.randint(1, 5)))
        cfg = apply_options(cfg, [f'data.train.ann_file={ann}',
                                  f'data.train.img_prefix={prefix}'])
        batch = batch_to_device(next(iter(build_bottomup_loader(cfg))),
                                'cuda')
    est = init_pose_model(path, device='cuda')
    stats = {k: v.clone() for k, v in est.state_dict().items()
             if 'running_' in k}
    state = bottomup_train_state(
        est, cfg.get('optimizer', {}).get('base_lr', 1.5e-3), [])
    step = make_bottomup_train_step(est)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    m = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m2 = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = {k: float(v) for k, v in m.items()}
    check(all(np.isfinite(v) for v in losses.values())
          and all(np.isfinite(float(v)) for v in m2.values()),
          f'bu-ms-train {name}: non-finite metrics {losses}')
    moved = [k for k, v in est.state_dict().items()
             if k in stats and not torch.equal(v, stats[k])]
    check(stats and len(moved) == len(stats), f'bu-ms-train {name}: '
          f'{len(stats) - len(moved)} of {len(stats)} BN statistics did '
          'not move')
    k1, k2 = fused_attention.launches, fused_attention_bwd.launches
    check(k1 == 0 and k2 == 0, f'bu-ms-train {name}: K1 {k1} and K2 {k2} '
          'launches, expected none')
    print(f'bu-ms-train: {name} ({path}, f32, TF32 on for convs, batch {n}, '
          f'{tuple(batch["imgs"].shape[1:3])} -> '
          f'{tuple(batch["heatmaps"].shape[2:])}): losses ' + ', '.join(
              f'{k} {v:.5f}' for k, v in losses.items())
          + f', all finite; {len(moved)} BN statistics moved; second step '
          f'{step_ms:.1f} ms = {n / step_ms * 1e3:.1f} img/s; peak '
          f'{peak:.2f} GB; 0 K1 and 0 K2 launches; on {card}', flush=True)
    del state, est, batch
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, peak_gb=peak, losses=losses, k1=k1, k2=k2)


def bu_ms_launches(bu_ms, key):
    """A kernel's launches on the bu-ms paths ('k1' or 'k2')."""
    report = bu_ms['bu_ms']
    return {'bu_ms_serve': {n: report[n][key] for n, _ in BU_MS_CONFIGS},
            'bu_ms_train': {n: report['train'][n][key]
                            for n, _ in BU_MS_CONFIGS}}


def bu_launches(bu, key):
    """A kernel's launches on each bottom-up path ('k1' or 'k2')."""
    return {'bu_serve': bu['serve'][key], 'bu_eval': bu['eval'][key],
            'bu_train': bu['train'][key],
            'bu_apps_per_frame': bu['apps'][f'{key}_per_frame']}


# --- top-down, the rest: HRFormer (item 12c), DeepPose, CombinedTarget,
# AdaptiveWing and the image augmentations (item 7), PoseTrack18 and
# Sub-JHMDB (item 12d's datasets) ---------------------------------------

TD_CONFIGS = {name: f'vitpose_tpu/configs/{path}.py' for name, path in (
    ('hrformer_base', 'coco/hrformer_base_coco_256x192'),
    ('hrformer_small', 'coco/hrformer_small_coco_256x192'),
    ('deeppose_res50', 'coco/deeppose_res50_coco_256x192'),
    ('udp_regress', 'coco/hrnet_w32_coco_256x192_udp_regress'),
    ('awing_res50', 'coco/res50_coco_256x192_awing'),
    ('photometric', 'coco/hrnet_w32_coco_256x192_photometric'),
    ('posetrack', 'posetrack/hrnet_w32_posetrack18_256x192'),
    ('jhmdb', 'jhmdb/res50_jhmdb_sub1_256x256'))}
# HRFormer-B's train-ref crops (w, h): half the config's 192x256 in each
# axis. Its float64 run on the CPU (the depthwise convs and the window
# attention in f64) costs about 80 s more at 192x256. On 48x64 crops the
# lowest branch is 2x2 (8 values per BN channel over 2 crops, most of a
# 7x7 window padding), f32 loses most digits there on either device, and
# CUDA's grad_norm left the f64 one by 185x the CPU's distance
HRFORMER_REF_CROP = (96, 128)
# CPU threads of F64Run's child (the host has 8 cores): the f64 depthwise
# convs are bound by one thread's dispatch, and the phases beside it keep
# the rest
F64_RUN_THREADS = 2
# the video sets: (images, people per image, joints, image (h, w))
TD_VIDEO_SETS = {'posetrack': (8, 3, 17, (1080, 1920)),
                 'jhmdb': (16, 1, 15, (240, 320))}


def window_attention_probe(pm, imgs, c, s, med_s):
    """HRFormer's window attention in the 256-crop serve batch: its MACs
    and the bytes its products read and write (from the shapes each block
    sees), and its card time by CUDA events around every WindowMSA call,
    split into the partition and merge copies, the qkv and proj Linears,
    and the rest (the two einsums, the bias gather and the softmax); then
    torch.profiler's top kernels of the batch."""
    from vitpose_tpu_torch.models import hrformer
    spans = {'window_attention': [], 'partition_merge': [], 'linear': []}
    shapes = []
    saved = {k: getattr(hrformer, k) for k in
             ('window_partition', 'window_merge', 'linear')}
    forward = hrformer.WindowMSA.forward

    def timed(name, fn):
        def run(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            spans[name].append(ev)
            return out
        return run

    def msa(self, x, dtype):
        ws = self.window_size
        h, w = x.shape[1:3]
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        shapes.append((x.shape[0] * hp * wp // ws ** 2, self.num_heads,
                       ws * ws, x.shape[3] // self.num_heads,
                       x.element_size()))
        return timed('window_attention', forward)(self, x, dtype)

    hrformer.WindowMSA.forward = msa
    hrformer.window_partition = timed('partition_merge',
                                      saved['window_partition'])
    hrformer.window_merge = timed('partition_merge', saved['window_merge'])
    hrformer.linear = timed('linear', saved['linear'])
    try:
        pm.infer_batch(imgs, c, s)
        torch.cuda.synchronize()
    finally:
        hrformer.WindowMSA.forward = forward
        for k, v in saved.items():
            setattr(hrformer, k, v)
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    ms['einsum_bias_softmax'] = (ms['window_attention']
                                 - ms['partition_merge'] - ms['linear'])
    # QK^T and PV: 2 * b * heads * T^2 * d MACs; q, k and v read and the
    # output written once (the logits need not leave the chip); f32 at the
    # CUDA cores' peak (matmul TF32 is off, as torch starts)
    macs = sum(2 * b * h * t * t * d for b, h, t, d, _ in shapes)
    nbytes = sum(4 * b * h * t * d * e for b, h, t, d, e in shapes)
    bound = max(2 * macs / (67e12 if shapes[0][4] == 4 else 989e12),
                nbytes / HBM_BYTES_PER_S) * 1e3
    busy = profile_steps(lambda: pm.infer_batch(imgs, c, s), med_s, steps=1,
                         label='td-rest-attention')
    share = None if busy is None else ms['window_attention'] / busy
    print(f'td-rest-attention: HRFormer-B 256-crop batch ({med_s * 1e3:.1f} '
          f'ms): {len(shapes)} window-attention calls, '
          f'{macs / 1e9:.1f} GMAC and {nbytes / 1e9:.2f} GB in its products '
          f'(bound {bound:.2f} ms); card ms by CUDA events: ' + ', '.join(
              f'{k} {v:.1f}' for k, v in ms.items())
          + (f'; {share:.3f} of the {busy:.1f} ms the card was busy'
             if busy else '; card busy time not measured'), flush=True)
    return dict(calls=len(shapes), gmac=macs / 1e9, gbytes=nbytes / 1e9,
                bound_ms=bound, ms=ms, busy_ms=busy, share=share)


def write_video_set(root, seed, name):
    """A synthetic set of `name` ('posetrack' or 'jhmdb', TD_VIDEO_SETS) in
    `root`: dim random JPEGs with a bright square per person, people with
    boxes and joints around the box centre; PoseTrack's images in two
    videos (vid_id, the last frame unlabelled) and its people with head
    boxes. Returns the annotation file and the number of people."""
    import cv2
    n_img, per, k, (h, w) = TD_VIDEO_SETS[name]
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n_img):
        img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
        file_name = f'{i:06d}.jpg'
        im = dict(id=i + 1, file_name=file_name, width=w, height=h)
        if name == 'posetrack':
            im.update(vid_id=f'{1 + i % 2:06d}', frame_id=i,
                      is_labeled=i < n_img - 2)
        images.append(im)
        for p in range(per):
            bw, bh = w / (per + 1) * 0.8, h * 0.7
            x, y = w * (p + 0.6) / (per + 1) - bw / 2, h * 0.15
            cx, cy = int(x + bw / 2), int(y + bh / 2)
            img[cy - 12:cy + 12, cx - 12:cx + 12] = 255
            xy = np.array([x + bw / 2, y + bh / 2]) + rng.normal(
                0, 6, (k, 2))
            v = np.where(rng.rand(k) < 0.9, 2, 0)
            ann = dict(id=len(anns) + 1, image_id=i + 1, category_id=1,
                       bbox=[float(x), float(y), float(bw), float(bh)],
                       area=float(bw * bh), iscrowd=0,
                       num_keypoints=int((v > 0).sum()),
                       keypoints=np.concatenate([xy, v[:, None]], 1)
                       .ravel().tolist())
            if name == 'posetrack':
                ann.update(bbox_head=[cx - 20.0, y, 40.0, 40.0], track_id=p)
            anns.append(ann)
        cv2.imwrite(os.path.join(root, file_name), img[..., ::-1])
    path = os.path.join(root, 'ann.json')
    with open(path, 'w') as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), f)
    return path, len(anns)


def phase_td_video_eval(card):
    """The evaluation CLI on the PoseTrack18 (HRNet-W32 bf16; the config's
    1280-pixel canvas, so the 1080x1920 frames shrink) and Sub-JHMDB
    (ResNet-50) configs with seeded weights saved as a .pth, each on a
    small synthetic set: the tables it writes (poseval's AP per part, PCK
    and tPCK per part), in range, 0 K1 and K2 launches, the CLI's wall
    time."""
    import io
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.tools import test as cli
    torch_tf32_defaults()
    out = {}
    for name, lead in (('posetrack', 'Total AP'), ('jhmdb', 'Mean PCK')):
        path = TD_CONFIGS[name]
        with tempfile.TemporaryDirectory() as root:
            ann, people = write_video_set(root, 7, name)
            pm = init_pose_model(path, device='cuda')
            ckpt = os.path.join(root, 'weights.pth')
            torch.save(pm.model.state_dict(), ckpt)
            del pm
            out_json = os.path.join(root, 'stats.json')
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                stats = cli.main([path, ckpt, '--out', out_json,
                                  '--cfg-options',
                                  f'data.val.ann_file={ann}',
                                  f'data.val.img_prefix={root}/'])
            cli_s = time.perf_counter() - t0
            k1, k2 = fused_attention.launches, fused_attention_bwd.launches
        top = 100 if name == 'posetrack' else 1
        check(k1 == 0 and k2 == 0, f'td-rest-video {name}: K1 {k1} and K2 '
              f'{k2} launches, expected none')
        check(all(np.isfinite(v) and 0 <= v <= top for v in stats.values())
              and lead in stats, f'td-rest-video {name}: stats {stats}')
        print(f'td-rest-video: CLI on {path} over {people} synthetic people '
              f'in {TD_VIDEO_SETS[name][0]} images '
              f'({TD_VIDEO_SETS[name][3][1]}x{TD_VIDEO_SETS[name][3][0]}): '
              f'{cli_s:.1f} s with model build and checkpoint load, 0 K1 and '
              f'0 K2 launches; table (random weights) ' + ', '.join(
                  f'{k} {v:.4f}' for k, v in stats.items())
              + f'; on {card}', flush=True)
        out[name] = dict(stats={k: float(v) for k, v in stats.items()},
                         cli_s=cli_s, k1=k1, k2=k2)
    return out


def phase_td_train(card, hrformer_f64=None):
    """One timed train step at the config's batch of HRFormer-B, DeepPose
    (smooth L1), HRNet-W32 with CombinedTarget and ResNet-50 with the
    adaptive wing loss (each the median of CNN_TIMED_STEPS, with its kernels
    profiled); the HRFormer-B train-ref (its float64 run from the F64Run
    `hrformer_f64` where given); then the training CLI on the
    photometric config for one epoch of 2 steps at batch 64: step wall
    time and the data_time share (the photometric distortion runs on the
    host, per canvas)."""
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    torch_tf32_defaults()
    reset_counts()
    steps = {}
    for name in ('hrformer_base', 'deeppose_res50', 'udp_regress',
                 'awing_res50'):
        ms, peak, busy = cnn_step_ms(TD_CONFIGS[name], card)
        steps[name] = dict(ms=ms, img_s=TRAIN_BATCH / ms * 1e3,
                           peak_gb=peak, kernel_ms=busy)
        print(f'td-rest-train: {name} step (runner state, the config\'s '
              f'dtype, target and loss) at batch {TRAIN_BATCH}: median '
              f'{ms:.1f} ms over {CNN_TIMED_STEPS} = '
              f'{TRAIN_BATCH / ms * 1e3:.1f} img/s, peak {peak:.2f} GB; on '
              f'{card}', flush=True)
    t0 = time.perf_counter()
    ref = phase_cnn_train_ref(TD_CONFIGS['hrformer_base'],
                              'td-rest-train-ref', HRFORMER_REF_CROP,
                              hrformer_f64)
    print(f'td-rest-train: the train-ref took {time.perf_counter() - t0:.1f} '
          's', flush=True)
    path = TD_CONFIGS['photometric']
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, 'train'))
        files, _ = write_eval_set(os.path.join(root, 'train'), 6,
                                  *PHOTOMETRIC_IMAGES)
        work_dir = os.path.join(root, 'work')
        t0 = time.perf_counter()
        state, log = run_train_cli([
            path, '--work-dir', work_dir, '--cfg-options',
            f'data.train.ann_file={files["ann"]}',
            f'data.train.img_prefix={root}/train/',
            f'data.val.ann_file={files["ann"]}',
            f'data.val.img_prefix={root}/train/',
            f'data.val.bbox_file={files["det"]}',
            'runtime.eval_interval=10', 'runtime.ckpt_interval=10',
            'runtime.log_interval=1', 'optimizer.total_epochs=1'])
        run_s = time.perf_counter() - t0
    train = [r for r in log if r['mode'] == 'train']
    check(len(train) == state.step == 2 and all(
        np.isfinite(r[k]) for r in train
        for k in ('heatmap_loss', 'grad_norm', 'acc_pose')),
        f'td-rest-train photometric: {len(train)} steps, state at '
        f'{state.step}, metrics {train[-1:]}')
    del state
    times = step_times(train)
    med = statistics.median(times)
    last = train[-1]
    share = last['data_time'] / last['time']
    k1, k2 = fused_attention.launches, fused_attention_bwd.launches
    check(k1 == 0 and k2 == 0, f'td-rest-train: K1 {k1} and K2 {k2} '
          'launches, expected none')
    print(f'td-rest-train: CLI on {path} (photometric distortion on the '
          f'host canvas), 2 steps at batch {TRAIN_BATCH}: step wall time '
          f'median {med * 1e3:.1f} ms ({min(times) * 1e3:.1f}-'
          f'{max(times) * 1e3:.1f}), data_time share {share:.3f} '
          f'({last["data_time"]:.2f} of {last["time"]:.2f} s); whole run '
          f'{run_s:.1f} s; 0 K1 and 0 K2 launches in every step; on {card}',
          flush=True)
    return dict(steps=steps, ref=ref, photometric_cli_ms=med * 1e3,
                photometric_data_time_share=share, k1=k1, k2=k2)


def run_td_rest_phases(card, hrformer_f64=None):
    """The new top-down paths in order (serve, ref, train, eval, video),
    each timed (`hrformer_f64` as phase_td_train takes it); returns their
    report."""
    cfgs = TD_CONFIGS
    return run_phases('td-rest', (
        ('serve', lambda c: phase_cnn_serve(
            c, [(n, cfgs[n]) for n in ('hrformer_base', 'deeppose_res50')],
            'td-rest-serve')),
        ('ref', lambda c: phase_cnn_ref(
            c, [(n, cfgs[n]) for n in ('hrformer_base', 'hrformer_small')],
            (), 'td-rest-ref', grid=(2, 2))),
        ('train', lambda c: phase_td_train(c, hrformer_f64)),
        ('eval_deeppose', lambda c: phase_cnn_eval(
            c, cfgs['deeppose_res50'], 'DeepPose-Res50 f32, the regression '
            'decode', 'td-rest-eval', TD_EVAL_IMAGES)),
        ('eval_udp_regress', lambda c: phase_cnn_eval(
            c, cfgs['udp_regress'], 'HRNet-W32 bf16, the UDP CombinedTarget '
            'decode', 'td-rest-eval')),
        ('video', phase_td_video_eval)), card)


def td_rest_launches(td, key):
    """A kernel's launches on each of the new top-down paths ('k1' or
    'k2')."""
    return {'td_rest_serve': {n: r[key] for n, r in td['serve'].items()},
            'td_rest_train': td['train'][key],
            'td_rest_eval': {'deeppose_res50': td['eval_deeppose'][key],
                             'udp_regress': td['eval_udp_regress'][key]},
            'td_rest_video_eval': {n: r[key]
                                   for n, r in td['video'].items()}}


# --- video and 3D pose: PoseWarper (item 12d) and the pose lifters (item
# 12e) ----------------------------------------------------------------------

PW_CFG = 'vitpose_tpu/configs/posetrack/posewarper_hrnet_w48_posetrack18.py'
PW_BATCH = 16                         # the config's batch of windows
# the shaped offsets' RMS over the probe windows, pixels of the 1/4 map
PW_OFFSET_RMS_PX = 2.5
# the train-ref's crops (w, h), as HRFormer-B's: its float64 run of
# HRNet-W48 and the 20-block neck on the CPU goes on in a child process
# (F64Run) through the td-rest group
PW_REF_CROP = (96, 128)
# pw-train-ref: CUDA's 2-step parameter distance from f64 (ref_distances)
# stays below this; Adam moves a parameter by about the lr whatever its
# gradient, so one whose gradient is mostly rounding flips sign between
# f32 and f64 (about a third on CUDA and on the CPU alike, PERF.md §6),
# where a state that did not move reads 1 and one moved the wrong way 2
PW_REF_PARAMS_CAP = 0.7
PW_TRAIN_STEPS = 1                    # timed steps after one warm-up
# the synthetic PoseTrack18 set: videos, frames per video (the last two
# unlabelled), people per labelled frame, frame (h, w)
PW_VIDEOS, PW_VIDEO_FRAMES, PW_PEOPLE, PW_FRAME_HW = 2, 10, 2, (720, 1280)
LIFT_CFGS = {name: f'vitpose_tpu/configs/body3d/{name}.py' for name in (
    'videopose3d_h36m_243frames', 'videopose3d_h36m_27frames',
    'videopose3d_h36m_27frames_semi_supervised', 'simplebaseline3d_h36m',
    'simplebaseline3d_3dhp')}
LIFT_BATCH = 1024                     # windows in the timed lifter batch
LIFT_REF_BATCH = 64
# the synthetic H36M-layout sets: (sequence name, frames); the first
# camera is in the cameras .pkl, the second takes the nominal sensor
LIFT_SEQS = (('S1_Directions_1.54138969', 120),
             ('S5_Walking.55011271', 90))
LIFT_CAMERA = dict(w=1000, h=1002, f=[[1145.0], [1143.8]],
                   c=[[512.5], [515.4]], k=[[-0.207], [0.247], [-0.003]],
                   p=[[-0.0009], [-0.0004]])


def pw_mdict(dtype):
    """The PoseWarper config's model dict, its backbone and neck in
    `dtype`."""
    mdict = cnn_model_dict(PW_CFG, dtype)
    mdict['neck'] = dict(mdict['neck'], dtype=dtype)
    return mdict


@functools.lru_cache(maxsize=1)
def pw_weights():
    """The state dict of the PoseWarper config's model at full width on
    the CPU (f32): weights from torch.Generator 0, then `shape_warps`."""
    from vitpose_tpu_torch.train.loop import build_model_from_cfg
    model = build_model_from_cfg(pw_mdict('float32'),
                                 torch.Generator().manual_seed(0))
    shape_warps(model, 0)
    return model.state_dict()


def pw_model(dtype='float32'):
    """The PoseWarper config's model with pw_weights() on the CPU, in
    `dtype` (float64: the backbone, the neck and the weights)."""
    from vitpose_tpu_torch.train.loop import build_model_from_cfg
    with torch.device('meta'):
        model = build_model_from_cfg(pw_mdict(dtype))
    model.load_state_dict({k: v.clone() for k, v in pw_weights().items()},
                          assign=True)
    return model.double() if dtype == 'float64' else model


def shape_warps(model, seed):
    """The config's neck is an exact identity warp (zero offset convs,
    identity deformable kernels), which samples nothing between pixels:
    give each deformable kernel a seeded perturbation of the identity, and
    the offset convs seeded weights scaled so that the offsets' RMS over
    two seeded probe windows at PW_REF_CROP (on the CPU, f32) is
    PW_OFFSET_RMS_PX: fractional offsets of a few pixels, many samples past
    the border."""
    neck = model.neck
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for layer in neck.deform_conv_layers:
            w = layer.weight
            w.add_(0.5 * torch.randn(w.shape, generator=gen)
                   / w[0].numel() ** 0.5)
        w, h = PW_REF_CROP
        frames = torch.randn(2, 5, h, w, 3, generator=gen)
        model.float().eval()
        feats = model.backbone(frames.reshape(10, h, w, 3))
        sup = neck.trans_layer(feats)
        key = sup.reshape(2, 5, *sup.shape[1:])[:, 0]
        diff = neck.offset_feats(key.repeat_interleave(5, 0) - sup)
        for layer in neck.offset_layers:
            layer.weight.copy_(torch.randn(layer.weight.shape,
                                           generator=gen))
            rms = layer(diff).pow(2).mean().sqrt()
            layer.weight.mul_(PW_OFFSET_RMS_PX / rms)


def warp_probe(model, frames):
    """(offset RMS, share of offsets with a fraction in [0.05, 0.95], share
    of bilinear samples past the border) of the neck's warps at every
    dilation on `frames` [N, T, H, W, 3] (eval mode, key frame 0)."""
    neck = model.neck
    with torch.no_grad():
        n, t = frames.shape[:2]
        feats = model.backbone(frames.reshape(n * t, *frames.shape[2:]))
        sup = neck.trans_layer(feats)
        key = sup.reshape(n, t, *sup.shape[1:])[:, 0]
        diff = neck.offset_feats(key.repeat_interleave(t, 0) - sup)
        rms, frac, out = [], [], []
        for d, layer in zip(neck.dilations, neck.offset_layers):
            off = layer(diff)
            m, _, h, w = off.shape
            xy = off.reshape(m, neck.groups, 3, 3, 2, h, w)
            taps = (torch.arange(3, device=off.device) - 1) * d
            y = (torch.arange(h, device=off.device)[:, None]
                 + taps[:, None, None, None] + xy[..., 0, :, :])
            x = (torch.arange(w, device=off.device)
                 + taps[None, :, None, None] + xy[..., 1, :, :])
            f = off.abs() - off.abs().floor()
            rms.append(off.pow(2).mean().sqrt().item())
            frac.append(((f > 0.05) & (f < 0.95)).float().mean().item())
            out.append(((y < 0) | (y > h - 1) | (x < 0) | (x > w - 1))
                       .float().mean().item())
    return rms, frac, out


def pw_windows(n, t, hw, seed, device):
    """`n` seeded windows of `t` normalised frames at `hw` (h, w)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(n, t, *hw, 3, generator=gen).to(device)


def pw_decode(heat, device):
    """keypoints_from_heatmaps of [N, K, 96, 72] maps at a fixed box."""
    from vitpose_tpu_torch.ops.decode import keypoints_from_heatmaps
    n = heat.shape[0]
    c = torch.tensor([[640.0, 360.0]], device=device).expand(n, 2)
    s = torch.tensor([[1.8, 2.4]], device=device).expand(n, 2)
    return keypoints_from_heatmaps(heat, c, s)


def phase_pw_serve(card):
    """The PoseWarper config at full width (HRNet-W48 at 384x288, the neck
    at 17 channels, 128 inner, 20 BasicBlocks, dilations 3-24, 17
    deformable groups), shape_warps weights, f32 (TF32 as torch starts): a
    16-window batch of 5 frames with the test frame weights, the flip test
    and the decode on the card, timed; its conv MACs per frame (count_ops)
    and the deformable contraction's; the neck and the deformable convs
    alone by CUDA events; the warps' offsets (fractional, a few pixels,
    many samples past the border); peak memory; 0 K1 and K2."""
    from vitpose_tpu_torch.data.dataset_info import DatasetInfo
    from vitpose_tpu_torch.eval.families import posewarper_heatmaps
    from vitpose_tpu_torch.models import necks
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    torch_tf32_defaults()
    t0 = time.perf_counter()
    model = pw_model().cuda().eval()
    build_s = time.perf_counter() - t0
    x = pw_windows(PW_BATCH, 5, (384, 288), 11, 'cuda')
    fw = torch.tensor([0.3, 0.1, 0.25, 0.25, 0.1], device='cuda')
    flip = torch.tensor(DatasetInfo.load('posetrack18').flip_index,
                        device='cuda')
    rms, frac, past = warp_probe(model, x[:2])
    check(all(0.5 < r < 50 for r in rms) and min(frac) > 0.5
          and min(past) > 0.01, f'pw-serve: offsets RMS {rms} px, '
          f'fractional share {frac}, past the border {past}')
    macs, bn = count_ops(lambda: model(x[:1], frame_weight=fw,
                                       key_index=0))
    macs, bn = macs / 5, bn / 5
    neck = model.neck
    # the deformable contraction per frame: 96 x 72 outputs x 17 x 17 x 9
    # per dilation
    dcn_macs = 96 * 72 * 17 * 17 * 9 * len(neck.dilations)

    def serve():
        with torch.no_grad():
            heat = posewarper_heatmaps(model, x, fw, flip)
            return pw_decode(heat, 'cuda')

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    preds, maxvals = serve()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(preds).all() and torch.isfinite(maxvals).all()),
          'pw-serve: non-finite keypoints')
    ms = time_ms(serve, calls=1, rounds=3, warmup=1)
    k1, k2 = fused_attention.launches, fused_attention_bwd.launches
    check(k1 == 0 and k2 == 0, f'pw-serve: K1 {k1} and K2 {k2} launches, '
          'expected none')
    # the neck and the deformable convs by CUDA events, in one more batch
    spans = {'neck': [], 'deform_conv': []}
    forward, dcn = type(neck).forward, necks.deform_conv2d

    def timed(name, fn):
        def run(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            spans[name].append(ev)
            return out
        return run

    type(neck).forward = timed('neck', forward)
    necks.deform_conv2d = timed('deform_conv', dcn)
    try:
        serve()
        torch.cuda.synchronize()
    finally:
        type(neck).forward = forward
        necks.deform_conv2d = dcn
    span_ms = {k: sum(a.elapsed_time(b) for a, b in v)
               for k, v in spans.items()}
    frames = PW_BATCH * 5 * 2
    conv_ms, bn_ms = cnn_bound_ms(macs, bn, torch.float32, frames)
    print(f'pw-serve: PoseWarper (HRNet-W48 384x288, the 20-block neck, 5 '
          f'dilations, 17 deformable groups; f32) model built in '
          f'{build_s:.1f} s; {PW_BATCH} windows of 5 frames, flip test and '
          f'decode on the card: median {ms:.1f} ms = '
          f'{PW_BATCH / ms * 1e3:.1f} windows/s ({frames} frame passes); '
          f'per frame {macs / 1e9:.2f} GMAC of convs, '
          f'{dcn_macs / 1e9:.3f} GMAC of deformable contraction, '
          f'{bn / 1e6:.2f} M BN\'d elements (bounds per batch: convs at the '
          f'TF32 peak {conv_ms:.1f} ms, BN traffic {bn_ms:.1f} ms); by CUDA '
          f'events the neck {span_ms["neck"]:.1f} ms, of it the deformable '
          f'convs {span_ms["deform_conv"]:.1f} ms; peak {peak:.2f} GB; '
          f'offsets RMS ' + '/'.join(f'{r:.2f}' for r in rms)
          + ' px, fractional ' + '/'.join(f'{v:.2f}' for v in frac)
          + ', samples past the border ' + '/'.join(f'{v:.3f}' for v in past)
          + f' per dilation; 0 K1, 0 K2; on {card}', flush=True)
    del model, x
    torch.cuda.empty_cache()
    return dict(ms=ms, windows_s=PW_BATCH / ms * 1e3, gmac_per_frame=macs /
                1e9, dcn_gmac_per_frame=dcn_macs / 1e9, bn_m_per_frame=bn /
                1e6, conv_bound_ms=conv_ms, bn_bound_ms=bn_ms,
                neck_ms=span_ms['neck'],
                deform_conv_ms=span_ms['deform_conv'], peak_gb=peak,
                offset_rms_px=rms, past_border=past, k1=k1, k2=k2)


def phase_pw_ref(card):
    """The same weights on CUDA and on the CPU in f32 (TF32 off), one
    5-frame window at 384x288 with the flip test: heatmaps within
    CNN_HM_RTOL of their largest value, decisive keypoints within
    KP_TOL_PX."""
    from vitpose_tpu_torch.data.dataset_info import DatasetInfo
    from vitpose_tpu_torch.eval.families import posewarper_heatmaps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = pw_model().eval()
    x = pw_windows(1, 5, (384, 288), 12, 'cpu')
    fw = torch.tensor([0.3, 0.1, 0.25, 0.25, 0.1])
    flip = DatasetInfo.load('posetrack18').flip_index
    out, took = {}, {}
    for dev in ('cuda', 'cpu'):
        model.to(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            heat = posewarper_heatmaps(model, x.to(dev), fw.to(dev),
                                       torch.tensor(flip, device=dev))
            preds, _ = pw_decode(heat, dev)
        out[dev] = heat.cpu().numpy(), preds.cpu().numpy()
        took[dev] = time.perf_counter() - t0
    (hm_c, kp_c), (hm_r, kp_r) = out['cuda'], out['cpu']
    top = np.abs(hm_r).max()
    bound = CNN_HM_RTOL * top
    hm_err = np.abs(hm_c - hm_r).max()
    check(hm_err <= bound, f'pw-ref: CUDA and CPU heatmaps differ by '
          f'{hm_err}, bound {bound}')
    dec = decisive_joints(hm_r, CNN_DECISIVE_BOUNDS * bound)
    check(dec.mean() >= 0.25, f'pw-ref: only {dec.sum()} of {dec.size} '
          'joints decisive')
    kp_err = np.abs(kp_c - kp_r).max(-1)[dec].max()
    check(kp_err <= KP_TOL_PX, f'pw-ref: decisive keypoints differ by '
          f'{kp_err} px')
    print(f'pw-ref: PoseWarper f32 (TF32 off), one 5-frame window at '
          f'384x288 with the flip test, CUDA vs CPU: heatmap max abs diff '
          f'{hm_err:.3e} (bound {bound:.3e} = {CNN_HM_RTOL:g} of max '
          f'|heatmap| {top:.3e}), decisive keypoints max diff {kp_err:.3e} '
          f'px (tol {KP_TOL_PX}) over {dec.sum()}/{dec.size} joints; the '
          f'call {took["cuda"]:.1f} s on CUDA, {took["cpu"]:.1f} s on the '
          f'CPU; on {card}', flush=True)
    torch_tf32_defaults()
    return dict(hm_err=float(hm_err), hm_bound=float(bound),
                kp_err_px=float(kp_err), decisive=int(dec.sum()),
                cpu_s=took['cpu'])


def write_posetrack_videos(root, seed):
    """A synthetic PoseTrack18 set in `root`: PW_VIDEOS videos, each in its
    own folder of PW_VIDEO_FRAMES consecutive %06d.jpg frames (PW_FRAME_HW,
    dim noise with a bright square per person that drifts from frame to
    frame) with `nframes`; PW_PEOPLE people with boxes, joints and head
    boxes on every frame but the last two. Returns the annotation file and
    the number of people."""
    import cv2
    h, w = PW_FRAME_HW
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for v in range(PW_VIDEOS):
        vid = f'{v + 1:06d}'
        os.makedirs(os.path.join(root, 'images', 'val', vid))
        for f in range(PW_VIDEO_FRAMES):
            img_id = (v + 1) * 1000 + f
            name = f'images/val/{vid}/{f:06d}.jpg'
            img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
            labelled = f < PW_VIDEO_FRAMES - 2
            images.append(dict(id=img_id, file_name=name, width=w, height=h,
                               vid_id=vid, frame_id=img_id,
                               nframes=PW_VIDEO_FRAMES,
                               is_labeled=labelled))
            for p in range(PW_PEOPLE):
                bw, bh = w / (PW_PEOPLE + 1) * 0.6, h * 0.7
                x = w * (p + 0.6) / (PW_PEOPLE + 1) - bw / 2 + 4 * f
                y = h * 0.15
                cx, cy = int(x + bw / 2), int(y + bh / 2)
                img[cy - 12:cy + 12, cx - 12:cx + 12] = 255
                if not labelled:
                    continue
                xy = np.array([cx, cy]) + rng.normal(0, 20, (17, 2))
                vis = np.where(rng.rand(17) < 0.9, 2, 0)
                anns.append(dict(
                    id=len(anns) + 1, image_id=img_id, category_id=1,
                    bbox=[float(x), float(y), float(bw), float(bh)],
                    area=float(bw * bh), iscrowd=0, track_id=p,
                    num_keypoints=int((vis > 0).sum()),
                    keypoints=np.concatenate([xy, vis[:, None]], 1)
                    .ravel().tolist(),
                    bbox_head=[cx - 20.0, y, 40.0, 40.0]))
            cv2.imwrite(os.path.join(root, name), img[..., ::-1])
    path = os.path.join(root, 'ann.json')
    with open(path, 'w') as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), f)
    return path, len(anns)


def phase_pw_eval(card):
    """The evaluation CLI on the PoseWarper config with shape_warps weights
    saved as a .pth, over the synthetic two-video set whose supports are
    real neighbouring frames (5-frame windows, the flip test, batch 16):
    poseval's AP per part, 0 K1 and K2, the CLI's wall time."""
    import io
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.tools import test as cli
    torch_tf32_defaults()
    with tempfile.TemporaryDirectory() as root:
        ann, people = write_posetrack_videos(root, 13)
        ckpt = os.path.join(root, 'posewarper.pth')
        torch.save(pw_model().state_dict(), ckpt)
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = cli.main([PW_CFG, ckpt, '--cfg-options',
                              f'data.val.ann_file={ann}',
                              f'data.val.img_prefix={root}/',
                              'data.val.bbox_file=None'])
        cli_s = time.perf_counter() - t0
    k1, k2 = fused_attention.launches, fused_attention_bwd.launches
    check(k1 == 0 and k2 == 0, f'pw-eval: K1 {k1} and K2 {k2} launches, '
          'expected none')
    check('Total AP' in stats and all(np.isfinite(v) and 0 <= v <= 100
                                      for v in stats.values()),
          f'pw-eval: stats {stats}')
    print(f'pw-eval: CLI on {PW_CFG} over {people} synthetic people in '
          f'{PW_VIDEOS} videos of {PW_VIDEO_FRAMES} frames '
          f'({PW_FRAME_HW[1]}x{PW_FRAME_HW[0]}; 5-frame windows of real '
          f'neighbours, flip test): {cli_s:.1f} s with model build and '
          f'checkpoint load, 0 K1 and 0 K2; table (random weights) '
          + ', '.join(f'{k} {v:.4f}' for k, v in stats.items())
          + f'; on {card}', flush=True)
    return dict(stats={k: float(v) for k, v in stats.items()}, cli_s=cli_s,
                people=people, k1=k1, k2=k2)


def pw_train_batch(ds, n, crop, seed):
    """`n` records of the train set through load_window with the config's
    augmentation (RandomState `seed`) at `crop` (w, h), and their MSRA
    targets (sigma 3) at a quarter of it, on the CPU."""
    from vitpose_tpu_torch.ops.target import generate_msra_heatmaps
    from vitpose_tpu_torch.train.posewarper_loop import load_window
    rng = np.random.RandomState(seed)
    wins = [load_window(ds.db[i % len(ds.db)], crop,
                        flip_pairs=ds.info.flip_pairs, rng=rng,
                        info=ds.info, half_body_prob=0.3)
            for i in range(n)]
    target, weight = generate_msra_heatmaps(
        torch.from_numpy(np.stack([w[1] for w in wins])),
        torch.from_numpy(np.stack([w[2] for w in wins])), crop,
        tuple(v // 4 for v in crop), sigma=3.0)
    return (torch.from_numpy(np.stack([w[0] for w in wins])), target,
            weight)


def pw_train_run(dtype, device, batch):
    """Two PoseWarper steps (Adam 1e-4, trans_layer frozen, the train
    frame weights (0, 1), key frame 0) of pw_model(dtype) on `batch`:
    (metrics of step 1 with the gradients' global norm, its gradients, the
    2-step change of every parameter and BN statistic), on the CPU in f64,
    in train_run's layout for ref_distances."""
    from vitpose_tpu_torch.train.bottomup_loop import piecewise_constant_lr
    from vitpose_tpu_torch.train.family_loop import adam
    from vitpose_tpu_torch.train.posewarper_loop import (posewarper_step,
                                                         trainable_parameters)
    from vitpose_tpu_torch.utils.config import load_config
    model = pw_model(dtype).to(device)
    cfg = load_config(PW_CFG)
    optimizer, scheduler = adam(trainable_parameters(model, cfg), 1e-4,
                                piecewise_constant_lr(1e-4, ()))
    dt = torch.float64 if dtype == 'float64' else torch.float32
    frames, target, weight = (t.to(device, dt) for t in batch)
    fw = torch.tensor([0.0, 1.0], device=device, dtype=dt)
    trained = {id(p) for p in optimizer.param_groups[0]['params']}
    names = [n for n, p in model.named_parameters() if id(p) in trained]
    before = snapshot(model)
    m = posewarper_step(model, optimizer, scheduler, frames, target, weight,
                        fw)
    params = dict(model.named_parameters())
    grads = {n: params[n].grad.double().cpu() for n in names}
    metrics = {'heatmap_loss': m['heatmap_loss'].item(),
               'grad_norm': torch.nn.utils.get_total_norm(
                   list(grads.values())).item()}
    posewarper_step(model, optimizer, scheduler, frames, target, weight, fw)
    after = snapshot(model)
    # the frozen trans_layer stays out: it does not move on either side
    return metrics, grads, {n: (after[n] - before[n]).double().cpu()
                            for n in after
                            if not n.startswith('neck.trans_layer.')}


def pw_f64_child(batch_file, out):
    """pw_train_run in float64 on the CPU on F64_RUN_THREADS threads, the
    batch read from `batch_file`, saved to `out` (F64Run's child)."""
    torch.set_num_threads(F64_RUN_THREADS)
    run = pw_train_run('float64', 'cpu', torch.load(batch_file))
    torch.save(run, out + '.part')
    os.replace(out + '.part', out)


def pw_train_set(root):
    """The synthetic video set as the train split's PoseTrackVideoDataset
    (one random adjacent support per record, the config's recipe)."""
    from vitpose_tpu_torch.data.posetrack import PoseTrackVideoDataset
    ann, _ = write_posetrack_videos(root, 14)
    return ann, PoseTrackVideoDataset(ann, root + '/', image_size=(288, 384),
                                      heatmap_size=(72, 96))


def phase_pw_train(card, f64_run=None):
    """The training CLI on the PoseWarper config at batch 16 (2-frame
    windows, the config's augmentation), 2 steps, then --resume for 2 more:
    trans_layer bit for bit as built, every other weight moved; steps of
    the shape_warps model at batch 16 on windows from the set (median of
    PW_TRAIN_STEPS after a warm-up, peak memory, one profiled step's
    kernel time and idle share); the train-ref: 2 steps at batch 2 of
    PW_REF_CROP windows, f32 (TF32 off) on CUDA and the CPU against the
    float64 run (F64Run `f64_run`, or here) under cnn-train-ref's rule; 0
    K1 and K2."""
    import io
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.tools import train as cli
    from vitpose_tpu_torch.train.bottomup_loop import piecewise_constant_lr
    from vitpose_tpu_torch.train.family_loop import adam
    from vitpose_tpu_torch.train.posewarper_loop import (posewarper_step,
                                                         trainable_parameters)
    from vitpose_tpu_torch.utils.config import load_config
    torch_tf32_defaults()
    reset_counts()
    with tempfile.TemporaryDirectory() as root:
        ann, ds = pw_train_set(root)
        work = os.path.join(root, 'work')
        args = [PW_CFG, '--work-dir', work, '--max-steps', '2',
                '--cfg-options', f'data.train.ann_file={ann}',
                f'data.train.img_prefix={root}/']
        walls = []
        for extra in ([], ['--resume']):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                trained, metrics = cli.main(args + extra)
            walls.append(time.perf_counter() - t0)
            del trained
            torch.cuda.empty_cache()
            check(np.isfinite(metrics['heatmap_loss']),
                  f'pw-train: CLI metrics {metrics}')
        final = torch.load(os.path.join(work, 'final.pth'),
                           weights_only=True)
        # the CLI builds the config's model from torch.Generator 0, as
        # pw_weights does before shape_warps, which leaves trans_layer and
        # the backbone as built
        built = pw_weights()
        frozen = [n for n in final if n.startswith('neck.trans_layer.')]
        check(frozen and all(torch.equal(final[n], built[n])
                             for n in frozen),
              'pw-train: trans_layer moved in training')
        moved = sum(not torch.equal(final[n], built[n]) for n in final
                    if n.startswith('backbone.') and 'running' not in n
                    and 'num_batches' not in n)
        total = sum(n.startswith('backbone.') and 'running' not in n
                    and 'num_batches' not in n for n in final)
        check(moved > 0.9 * total, f'pw-train: {moved} of {total} backbone '
              'tensors moved')
        batch = pw_train_batch(ds, PW_BATCH, (288, 384), 15)
        ref_batch_ = pw_train_batch(ds, 2, PW_REF_CROP, 16)
    del final
    model = pw_model().cuda()
    optimizer, scheduler = adam(
        trainable_parameters(model, load_config(PW_CFG)), 1e-4,
        piecewise_constant_lr(1e-4, ()))
    frames, target, weight = (t.cuda() for t in batch)
    fw = torch.tensor([0.0, 1.0], device='cuda')

    def step():
        return posewarper_step(model, optimizer, scheduler, frames, target,
                               weight, fw)

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(PW_TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step()
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    check(np.isfinite(m['heatmap_loss'].item()),
          f'pw-train: step loss {m}')
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(times)
    busy = profile_steps(step, med, steps=1, label='pw-train')
    k1, k2 = fused_attention.launches, fused_attention_bwd.launches
    check(k1 == 0 and k2 == 0, f'pw-train: K1 {k1} and K2 {k2} launches, '
          'expected none')
    print(f'pw-train: CLI on {PW_CFG}, batch {PW_BATCH} of 2-frame windows, '
          f'2 steps {walls[0]:.1f} s, --resume 2 more {walls[1]:.1f} s '
          f'(with data and model build); trans_layer bit for bit as built, '
          f'{moved} of {total} backbone tensors moved; step (f32, TF32 '
          f'convs) median '
          f'{med * 1e3:.1f} ms over {PW_TRAIN_STEPS} = '
          f'{PW_BATCH / med:.1f} windows/s, peak {peak:.2f} GB; 0 K1, 0 K2; '
          f'on {card}', flush=True)
    del model, optimizer, frames, target, weight
    torch.cuda.empty_cache()
    ref = pw_train_ref(ref_batch_, f64_run)
    return dict(cli_s=walls, step_ms=med * 1e3, windows_s=PW_BATCH / med,
                peak_gb=peak, kernel_ms=busy, ref=ref, k1=k1, k2=k2)


def pw_train_ref(batch, f64_run=None):
    """pw_train_run f32 (TF32 off) on CUDA and on the CPU against float64
    by hold_train_ref, as phase_cnn_train_ref holds the CNNs. Every
    gradient but the deformable kernels' reaches its parameter through the
    warps' offsets, where a sample crossing a pixel edge jumps it (a change
    of the input in its last digits moves them by far more than rounding),
    so that rule is loose here; three checks hold what is smooth in the
    sample positions: CUDA's step-1 loss and the deformable kernels' step-1
    gradients against the CPU's within TRAIN_REF_TOL, and CUDA's 2-step
    parameter distance from f64 below PW_REF_PARAMS_CAP (a state that did
    not move reads 1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {dev: pw_train_run('float32', dev, batch)
            for dev in ('cuda', 'cpu')}
    if f64_run is None:
        exact = pw_train_run('float64', 'cpu', batch)
    else:
        exact, wait_s = f64_run.result()
        print(f'pw-train-ref: the float64 run came from its own process, '
              f'waited for {wait_s:.1f} s', flush=True)
    report = hold_train_ref(
        'pw-train-ref', runs, exact, f'PoseWarper, batch 2 of 2-frame '
        f'windows at {PW_REF_CROP[0]}x{PW_REF_CROP[1]}')
    params = report['cuda_vs_f64']['params']
    (m, g, _), (mc, gc, _) = runs['cuda'], runs['cpu']
    loss = abs(m['heatmap_loss'] - mc['heatmap_loss']) / mc['heatmap_loss']
    deform = max(((g[n] - gc[n]).abs().max() / gc[n].abs().max()).item()
                 for n in gc if n.startswith('neck.deform_conv_layers.'))
    print(f'pw-train-ref: CUDA against the CPU, f32, step 1: loss '
          f'{loss:.3e} (tol {TRAIN_REF_TOL["heatmap_loss"]:g}), the '
          f'deformable kernels\' gradients {deform:.3e} (tol '
          f'{TRAIN_REF_TOL["grads"]:g}); CUDA parameters {params:.3e} from '
          f'f64 (cap {PW_REF_PARAMS_CAP:g})', flush=True)
    check(params <= PW_REF_PARAMS_CAP, f'pw-train-ref: CUDA parameters '
          f'{params} from f64 (cap {PW_REF_PARAMS_CAP}; unmoved reads 1)')
    check(loss <= TRAIN_REF_TOL['heatmap_loss'],
          f'pw-train-ref: step-1 loss CUDA vs CPU {loss}')
    check(deform <= TRAIN_REF_TOL['grads'], f'pw-train-ref: step-1 '
          f'deformable kernels\' gradients CUDA vs CPU {deform}')
    torch_tf32_defaults()
    return dict(report, cuda_vs_cpu={'heatmap_loss': loss,
                                     'deform_grads': deform})


def start_pw_f64():
    """The PoseWarper train-ref's float64 run in its own process (F64Run),
    on a batch written from the synthetic set; returns the F64Run."""
    root = tempfile.mkdtemp(prefix='pwbatch')
    _, ds = pw_train_set(root)
    batch_file = os.path.join(root, 'batch.pt')
    torch.save(pw_train_batch(ds, 2, PW_REF_CROP, 16), batch_file)
    return F64Run(pw_f64_child, (batch_file,), cleanup=root)


def tcn_macs(kernel_sizes, t, cin=34, width=1024):
    """Conv1d MACs of one window through a TCN: the stem and, per block, the
    dilated conv1 and the 1x1 conv2, each output times its fan-in."""
    k0 = kernel_sizes[0]
    t = t - k0 + 1
    macs = t * width * cin * k0
    dil = k0
    for k in kernel_sizes[1:]:
        t -= (k - 1) * dil
        macs += t * width * width * k + t * width * width
        dil *= k
    return macs


def write_lift_sets(root, seed):
    """Synthetic H36M-layout sets in `root` (LIFT_SEQS; 3DHP's with the
    same layout), a cameras .pkl for the first sequence's camera, and the
    2D / root-free 3D stats .pkl files. Returns their paths."""
    import pickle
    rng = np.random.RandomState(seed)
    names = [f'{s}_{i:06d}.jpg' for s, n in LIFT_SEQS
             for i in range(1, n + 1)]
    n = len(names)
    out = {}
    for split in ('train', 'unlabeled', 'val', 'hp_train', 'hp_val'):
        pose = rng.randn(n, 17, 3) * 250 + [0, 0, 4500]
        out[split] = os.path.join(root, f'{split}.npz')
        np.savez(out[split], imgname=np.array(names),
                 center=rng.uniform(400, 600, (n, 2)),
                 scale=rng.uniform(1, 3, n),
                 part=np.concatenate([rng.uniform(150, 850, (n, 17, 2)),
                                      np.ones((n, 17, 1))], -1),
                 S=np.concatenate([pose, np.ones((n, 17, 1))], -1))
    out['cameras'] = os.path.join(root, 'cameras.pkl')
    with open(out['cameras'], 'wb') as f:
        pickle.dump({('S1', '54138969'): LIFT_CAMERA}, f)
    for name, k, d, scale in (('stats2d', 17, 2, 100),
                              ('stats3d', 16, 3, 250)):
        out[name] = os.path.join(root, f'{name}.pkl')
        with open(out[name], 'wb') as f:
            pickle.dump(dict(mean=rng.randn(k, d) * 10,
                             std=np.full((k, d), float(scale))), f)
    return out


def lift_options(sets, hp=False, cams=True):
    """--cfg-options pointing a body3d config at the synthetic sets."""
    opts = [f'data.train.ann_file={sets["hp_train" if hp else "train"]}',
            f'data.val.ann_file={sets["hp_val" if hp else "val"]}',
            f'data.train_unlabeled.ann_file={sets["unlabeled"]}']
    if cams:
        opts += [f'data.{s}.camera_param_file={sets["cameras"]}'
                 for s in ('train', 'val', 'train_unlabeled')]
    return opts


def phase_lift(card):
    """The pose lifters at full width (TCN 1024 wide): the 243-frame
    lifter on a 1024-window batch (f32, TF32 convs), timed, with its MACs;
    the 27-frame semi-supervised lifter (pose and trajectory) on CUDA
    against the CPU, f32 (TF32 off), 64 windows; the training CLI for 2
    steps on the semi-supervised config (the warm-up crossed at step 2)
    and on SimpleBaseline3D (stats .pkl, remove_root, MSE), with --resume;
    the evaluation CLI on an H36M set (27 frames, cameras) and a 3DHP set
    (SimpleBaseline3D: MPJPE, P-MPJPE, 3DPCK, 3DAUC); 0 K1 and K2."""
    import io
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.tools import test as test_cli
    from vitpose_tpu_torch.tools import train as train_cli
    from vitpose_tpu_torch.train.loop import build_model_from_cfg
    from vitpose_tpu_torch.utils.config import load_config
    torch_tf32_defaults()
    reset_counts()
    cfg243 = load_config(LIFT_CFGS['videopose3d_h36m_243frames'])['model']
    model = build_model_from_cfg(cfg243).cuda().eval()
    x = torch.randn(LIFT_BATCH, 243, 17, 2,
                    generator=torch.Generator().manual_seed(17)).cuda()

    def serve():
        with torch.no_grad():
            return model(x)

    check(bool(torch.isfinite(serve()).all()), 'lift: non-finite poses')
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(serve, calls=3, rounds=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 1e9
    macs = tcn_macs(cfg243['kernel_sizes'], 243)
    bound = max(2 * macs * LIFT_BATCH / 495e12,
                4 * LIFT_BATCH * 243 * 34 / HBM_BYTES_PER_S) * 1e3
    del model, x
    # CUDA against the CPU, the semi-supervised lifter
    semi = load_config(
        LIFT_CFGS['videopose3d_h36m_27frames_semi_supervised'])['model']
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lifter = build_model_from_cfg(semi).eval()
    xr = torch.randn(LIFT_REF_BATCH, 27, 17, 2,
                     generator=torch.Generator().manual_seed(18))
    outs = {}
    for dev in ('cuda', 'cpu'):
        lifter.to(dev)
        with torch.no_grad():
            outs[dev] = [o.cpu().numpy() for o in lifter(xr.to(dev))]
    errs = [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(outs['cuda'], outs['cpu'])]
    check(max(errs) <= CNN_HM_RTOL, f'lift: CUDA vs CPU pose / trajectory '
          f'differ by {errs} of their largest')
    torch_tf32_defaults()
    del lifter
    torch.cuda.empty_cache()
    report = dict(serve_ms=ms, windows_s=LIFT_BATCH / ms * 1e3,
                  gmac_per_window=macs / 1e9, bound_ms=bound, peak_gb=peak,
                  ref_err=errs)
    with tempfile.TemporaryDirectory() as root:
        sets = write_lift_sets(root, 19)
        train = {}
        for name, opts in (
                ('videopose3d_h36m_27frames_semi_supervised',
                 lift_options(sets) + ['loss_semi.warmup_iterations=1']),
                ('simplebaseline3d_h36m', lift_options(sets, cams=False) + [
                    f'joint_2d_normalize.stats_file={sets["stats2d"]}',
                    f'joint_3d_normalize.stats_file={sets["stats3d"]}'])):
            work = os.path.join(root, name)
            args = [LIFT_CFGS[name], '--work-dir', work, '--max-steps', '2',
                    '--cfg-options', 'evaluation.interval=0'] + opts
            walls = []
            for extra in ([], ['--resume']):
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    _, metrics = train_cli.main(args + extra)
                walls.append(time.perf_counter() - t0)
            check(all(np.isfinite(v) for v in metrics.values()),
                  f'lift: {name} metrics {metrics}')
            if 'semi' in name:
                check(metrics['proj_loss'] > 0 and metrics['bone_loss'] > 0,
                      f'lift: the warm-up did not open: {metrics}')
            train[name] = dict(cli_s=walls, metrics=metrics)
        ckpt = os.path.join(root, 'lifter.pth')
        evals = {}
        for name, opts in (
                ('videopose3d_h36m_27frames', lift_options(sets)),
                ('simplebaseline3d_3dhp', lift_options(
                    sets, hp=True, cams=False) + [
                    f'joint_2d_normalize.stats_file={sets["stats2d"]}',
                    f'joint_3d_normalize.stats_file={sets["stats3d"]}'])):
            torch.save(build_model_from_cfg(
                load_config(LIFT_CFGS[name])['model']).state_dict(), ckpt)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                stats = test_cli.main([LIFT_CFGS[name], ckpt,
                                       '--cfg-options'] + opts)
            evals[name] = dict(stats=stats, cli_s=time.perf_counter() - t0)
            check(all(np.isfinite(v) for v in stats.values()),
                  f'lift: {name} stats {stats}')
        check(set(evals['simplebaseline3d_3dhp']['stats']) == {
            'MPJPE', 'P-MPJPE', '3DPCK', '3DAUC'},
            f'lift: 3DHP table {evals["simplebaseline3d_3dhp"]["stats"]}')
    k1, k2 = fused_attention.launches, fused_attention_bwd.launches
    check(k1 == 0 and k2 == 0, f'lift: K1 {k1} and K2 {k2} launches, '
          'expected none')
    print(f'lift: 243-frame lifter (TCN 1024 wide, 5 blocks; f32, TF32 '
          f'convs), {LIFT_BATCH} windows: median {ms:.2f} ms = '
          f'{LIFT_BATCH / ms * 1e3:.0f} windows/s, '
          f'{macs / 1e9:.3f} GMAC a window (bound {bound:.3f} ms at the TF32 '
          f'peak), peak {peak:.2f} GB; 27-frame semi-supervised lifter, '
          f'CUDA vs CPU f32 (TF32 off), {LIFT_REF_BATCH} windows: pose / '
          f'trajectory max abs diff {errs[0]:.2e} / {errs[1]:.2e} of their '
          f'largest (tol {CNN_HM_RTOL:g}); training CLI, 2 steps then '
          f'--resume (s with data and model build): ' + '; '.join(
              f'{n} {r["cli_s"][0]:.1f} + {r["cli_s"][1]:.1f}, '
              + ', '.join(f'{k} {v:.4f}' for k, v in r['metrics'].items())
              for n, r in train.items())
          + '; evaluation CLI (random weights): ' + '; '.join(
              f'{n} {r["cli_s"]:.1f} s, ' + ', '.join(
                  f'{k} {v:.2f}' for k, v in r['stats'].items())
              for n, r in evals.items())
          + f'; 0 K1, 0 K2; on {card}', flush=True)
    report.update(train={n: dict(cli_s=r['cli_s'], metrics={
        k: float(v) for k, v in r['metrics'].items()})
        for n, r in train.items()}, eval={n: dict(cli_s=r['cli_s'], stats={
            k: float(v) for k, v in r['stats'].items()})
        for n, r in evals.items()}, k1=k1, k2=k2)
    return report


def lifted_pose_writer(results, skeleton=None, out_file=None, **kw):
    """The body3d demos' drawing call in the smoke: the card machine has no
    matplotlib, and drawing is host work, held on the CPU by
    tests/test_torch_lifter.py::test_body3d_demos_on_the_cpu. Checks the
    lifted poses (finite, [K, 3]) and writes them to `out_file` as an .npy
    array [people, K, 3]."""
    kp = np.stack([np.asarray(r['keypoints_3d']) for r in results])
    check(kp.ndim == 3 and kp.shape[2] in (3, 4) and np.isfinite(kp).all(),
          f'body3d demo: lifted poses {kp.shape}, finite '
          f'{np.isfinite(kp).all()}')
    with open(out_file, 'wb') as f:
        np.save(f, kp)


def phase_lift_demos(card):
    """Both body3d demos on the card with the COCO-B config and shaped
    weights for the 2D stage (bf16, K1): the image demo on a seeded
    480x640 scene (the whole image one box) and the video demo on an
    4-frame MJPG video of it; 24 K1 launches per frame at held shapes and
    no K2, every frame's lifted poses written (lifted_pose_writer in place of the
    matplotlib drawing), frames/s over main."""
    import cv2
    from vitpose_tpu_torch.demo import (body3d_two_stage_img_demo,
                                        body3d_video_demo)
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    modules = (body3d_two_stage_img_demo, body3d_video_demo)
    draw = [m.vis_pose_result_3d for m in modules]
    for m in modules:
        m.vis_pose_result_3d = lifted_pose_writer
    try:
        with tempfile.TemporaryDirectory() as root:
            ckpt = peaks_checkpoint(root, COCO_B, 'vitpose_b_peaks')
            boxes = grid_boxes(np.random.RandomState(5), 1, 1)
            img = scene(5, boxes)
            img_path = os.path.join(root, 'person.jpg')
            cv2.imwrite(img_path, np.ascontiguousarray(img[..., ::-1]))
            video = write_video(os.path.join(root, 'person.avi'), img,
                                DEMO_FRAMES)
            out = os.path.join(root, 'vis')
            runs = {}
            for name, module, args, frames in (
                    ('body3d_two_stage_img_demo', body3d_two_stage_img_demo,
                     [img_path, '--variant', COCO_B, '--pose-checkpoint',
                      ckpt, '--out-img-root', out], 1),
                    ('body3d_video_demo', body3d_video_demo,
                     [video, '--variant', COCO_B, '--checkpoint', ckpt,
                      '--out-img-root', out], DEMO_FRAMES)):
                reset_counts()
                t0 = time.perf_counter()
                result = module.main(args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                check_shapes_held(name)
                k1 = fused_attention.launches
                k2 = fused_attention_bwd.launches
                check(k1 == 24 * frames, f'{name}: {k1} K1 launches over '
                      f'{frames} frames, expected 24 per frame')
                check(k2 == 0, f'{name}: {k2} K2 launches, expected none')
                paths = [result[1]] if frames == 1 else result[1]
                check(len(paths) == frames and all(
                    os.path.getsize(p) > 0 for p in paths),
                    f'{name}: outputs {paths}')
                runs[name] = dict(k1_per_frame=k1 / frames,
                                  k2_per_frame=k2 / frames, wall_s=wall,
                                  frames_s=frames / wall)
    finally:
        for m, fn in zip(modules, draw):
            m.vis_pose_result_3d = fn
    print('lift-demos: both body3d demos on the card (ViTPose-B bf16 with '
          'K1 for the 2D stage, the whole image as the box; the default '
          '27-frame lifter; each frame\'s lifted poses written where the '
          'demos draw with matplotlib, which the card machine lacks), K1 '
          'and K2 launches per frame, wall s of main and frames/s: '
          + '; '.join(
              f'{n} {r["k1_per_frame"]:g} and {r["k2_per_frame"]:g}, '
              f'{r["wall_s"]:.2f} s, '
              f'{r["frames_s"]:.1f}' for n, r in runs.items())
          + f'; on {card}', flush=True)
    return runs


def run_vid3d_phases(card, pw_f64=None):
    """The PoseWarper and lifter phases in order, each timed (`pw_f64` as
    phase_pw_train takes it); returns their report."""
    return run_phases('vid3d', (
        ('pw_serve', phase_pw_serve), ('pw_ref', phase_pw_ref),
        ('pw_eval', phase_pw_eval),
        ('pw_train', lambda c: phase_pw_train(c, pw_f64)),
        ('lift', phase_lift), ('lift_demos', phase_lift_demos)), card)


def vid3d_launches(vid, key):
    """A kernel's launches on each of the video and 3D paths ('k1' or
    'k2'): none but the body3d demos' K1 per frame."""
    return {'pw_serve': vid['pw_serve'][key], 'pw_eval': vid['pw_eval'][key],
            'pw_train': vid['pw_train'][key], 'lift': vid['lift'][key],
            'lift_demos_per_frame': {
                n: r[f'{key}_per_frame'] for n, r in vid['lift_demos'].items()}}


# --- the one-config families, item 12f: InterHand3D, HMR mesh, VoxelPose -

FAM_CFGS = {name: f'vitpose_tpu/configs/{path}.py' for name, path in (
    ('interhand3d', 'hand/res50_interhand3d_all_256x256'),
    ('mesh', 'mesh/hmr_res50_mixed_224x224'),
    ('voxelpose', 'body3d/voxelpose_prn64x64x64_cpn80x80x20_panoptic_cam5'))}
FAM_SERVE_BOXES = 64                  # the serve batch of crops
FAM_TIMED = 1                         # timed serve batches and steps
# the family train-refs, beyond hold_train_ref's rule (whose limits, a
# factor times the CPU's own distance from f64, do not fail a CUDA step
# that leaves every parameter where it was: Adam turns the rounding of a
# near-zero gradient into +-lr, so the CPU's f32 parameters sit 0.4-0.5
# from f64 in its RMS metric at the configs' crops, where an unmoved state
# reads 1): each held parameter tensor's 2-step distance from f64 on CUDA
# below FAM_REF_PARAMS_CAP, or below the CPU's own plus
# FAM_REF_PARAMS_SLACK where f32 on the CPU strays past the cap (a
# VoxelPose output conv ahead of the softmax, whose gradient cancels over
# the cube: 0.84 on the CPU with the weights of seed 1); and step 1
# against the CPU's f32 step 1, before Adam: the loss within TRAIN_REF_TOL
# and every held gradient tensor's RMS difference within
# FAM_STEP1_GRAD_TOL of its RMS (a zeroed tensor reads 1)
FAM_REF_PARAMS_CAP = 0.7
FAM_REF_PARAMS_SLACK = 0.1
FAM_STEP1_GRAD_TOL = 0.1
# VoxelPose's train-ref: the config's widths (V2VNets 32 wide), a smaller
# grid (20x20x8 space voxels, 16^3 cubes) so that the CPU's float64 run of
# the ten candidate cubes takes seconds
VP_REF_GEOM = dict(space_resolution=(20, 20, 8), cube_resolution=(16, 16, 16))
VP_CAMS = ('00_12', '00_06', '00_13', '00_04', '00_03')
VP_HM_SIZE = (128, 240)               # the heatmaps (h, w) of a view
VP_PEOPLE = 3


def fam_mdict(name, dtype=None, **over):
    """The family config's model dict (its trunk in `dtype` when given),
    with `over` on top."""
    from vitpose_tpu_torch.utils.config import load_config
    mdict = dict(load_config(FAM_CFGS[name])['model'], **over)
    if dtype and 'backbone_overrides' in mdict:
        mdict['backbone_overrides'] = dict(mdict['backbone_overrides'],
                                           dtype=dtype)
    return mdict


def fam_model(name, dtype='float32', seed=0, **over):
    """The family config's model with seeded weights (torch.Generator
    `seed`), in float64 (trunk and all) for dtype 'float64'."""
    from vitpose_tpu_torch.train.loop import build_model_from_cfg
    model = build_model_from_cfg(fam_mdict(name, dtype, **over),
                                 torch.Generator().manual_seed(seed))
    return model.double() if dtype == 'float64' else model


def k12():
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    return fused_attention.launches, fused_attention_bwd.launches


def check_no_kernels(what):
    k1, k2 = k12()
    check(k1 == 0 and k2 == 0, f'{what}: K1 {k1} and K2 {k2} launches, '
          'expected none')
    return k1, k2


def wall_steps_ms(step, n=FAM_TIMED):
    """Median wall ms of `n` calls of step() after one warm-up call, each
    synchronised, and the peak memory (GB) over them."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), torch.cuda.max_memory_allocated() / 1e9


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def family_holds(cuda, cpu, exact, left):
    """The family holds of the CUDA run `cuda` (train_run's layout) given
    the CPU's f32 run and the f64 run, the parameters `left` left out:
    [(what, value, limit)] (a value above its limit fails), and the
    per-tensor step-1 gradient distances."""
    _, params = ref_distances(cuda, exact, left)
    _, cpu_params = ref_distances(cpu, exact, left)
    # each tensor's distance over its limit, the largest
    over = {n: v / max(FAM_REF_PARAMS_CAP,
                       cpu_params[n] + FAM_REF_PARAMS_SLACK)
            for n, v in params.items()}
    (m, g, _), (mc, gc, _) = cuda, cpu
    loss = abs(m['heatmap_loss'] - mc['heatmap_loss']) / abs(
        mc['heatmap_loss'])
    grads = {n: ((g[n] - gc[n]).norm() / gc[n].norm()).item()
             for n in gc if n not in left}
    return [('2-step parameters from f64 over their limit',
             max(over.values()), 1.0),
            ('step-1 loss against the CPU', loss,
             TRAIN_REF_TOL['heatmap_loss']),
            ('step-1 gradients against the CPU', max(grads.values()),
             FAM_STEP1_GRAD_TOL)], grads


def family_ref_runs(label, run_fn, batch, desc, cudnn_off=False,
                    exact=None, **hold):
    """A family's train-ref: run_fn(dtype, device, batch) -> train_run's
    layout (metrics with 'heatmap_loss', the step's total loss, and
    'grad_norm'; step 1's gradients; the 2-step change), f32 with TF32 off
    on CUDA and on the CPU, held against the float64 run on the CPU by
    hold_train_ref's rule (`hold` its options) and by family_holds; a CUDA
    run whose steps leave the parameters unmoved, and one with its largest
    gradient tensor zeroed, must fail family_holds. With `cudnn_off` the
    CUDA run that hold_train_ref holds runs ATen's own CUDA convolutions,
    and a second CUDA run through cuDNN is held by family_holds. `exact`,
    where given, returns the float64 run (FamRefs.exact)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs, secs = {}, {}
    for dev in ('cuda', 'cpu') + (('cuda (cuDNN)',) if cudnn_off else ()):
        t0 = time.perf_counter()
        torch.backends.cudnn.enabled = dev != 'cuda' or not cudnn_off
        try:
            runs[dev] = run_fn('float32', dev.split()[0], batch)
        finally:
            torch.backends.cudnn.enabled = True
        secs[dev] = time.perf_counter() - t0
    t0 = time.perf_counter()
    secs['f64' if exact is None else 'f64 (waited for its process)'] = 0.0
    exact = run_fn('float64', 'cpu', batch) if exact is None else exact()
    secs[next(reversed(secs))] = time.perf_counter() - t0
    torch_tf32_defaults()
    left = []
    report = hold_train_ref(label, {d: runs[d] for d in ('cuda', 'cpu')},
                            exact, desc, left_out=left, **hold)
    cudas = [d for d in runs if d != 'cpu']
    holds = {}
    for dev in cudas:
        holds[dev], grads = family_holds(runs[dev], runs['cpu'], exact, left)
        print(f'{label}: {dev} f32 ' + ', '.join(
            f'{w} {v:.3e} (limit {tol:g})' for w, v, tol in holds[dev])
            + f'; largest step-1 gradient distances from the CPU: '
            f'{worst(grads)}', flush=True)
    m, g, d = runs['cuda']
    big = max((n for n in g if n not in left), key=lambda n: g[n].norm())
    noop = (m, g, {n: torch.zeros_like(t) for n, t in d.items()})
    zeroed = (m, dict(g, **{big: torch.zeros_like(g[big])}), d)
    broken = {what: [(w, v) for w, v, tol in family_holds(
        run, runs['cpu'], exact, left)[0] if v > tol]
        for what, run in (('unmoved', noop), (f'{big} zeroed', zeroed))}
    per_f64 = {dev: {n: ((r[1][n] - exact[1][n]).abs().max()
                         / exact[1][n].abs().max()).item()
                     for n in exact[1] if n not in left}
               for dev, r in runs.items()}
    print(f'{label}: largest step-1 gradient distances from f64 (the grads '
          'metric), ' + '; '.join(f'{dev}: {worst(v)}'
                                  for dev, v in per_f64.items())
          + '; a CUDA run fails the holds ' + '; '.join(
              f'{what} ({", ".join(f"{w} {v:.3g}" for w, v in fails)})'
              for what, fails in broken.items()) + '; runs took '
          + ', '.join(f'{k} {v:.1f} s' for k, v in secs.items()),
          flush=True)
    for dev in cudas:
        for w, v, tol in holds[dev]:
            check(v <= tol, f'{label}: {dev} {w} {v} (limit {tol})')
    for what, fails in broken.items():
        check(fails, f'{label}: a CUDA run with {what} passes the holds')
    return dict(report, held=len(exact[1]) - len(left), run_s=secs, **{
        f'holds_{dev}': {w: float(v) for w, v, _ in holds[dev]}
        for dev in cudas})


# VoxelPose's V2VNets put a conv with a bias before every BN (and a
# transposed conv before the upsamplers' BN): those biases' gradient is
# nought in exact arithmetic, and its f32 sums over the 16^3 x 10 candidate
# voxels of a 300 mm loss leave more than GRAD_NOISE_FLOOR of the largest
# gradient (the CPU's measured above 1e-6 on an H100 machine); they
# are held below VP_ZERO_FLOOR of it. The centre net learns from the centre
# loss alone and the pose net from the pose loss, whose L1 in mm dwarfs
# the other: each net's gradients are measured against its own largest
VP_ZERO_FLOOR = 1e-4
VP_REF_GROUPS = ('human_detector.', 'pose_regressor.')
# the train-ref's weight seeds: cuDNN's 3D convolutions put seed 0's CUDA
# gradients 5.6 times as far from f64 as the CPU's, ATen's own CUDA
# convolutions 0.4 times, and seed 1's output conv strays past
# FAM_REF_PARAMS_CAP on both devices (PERF.md §6, PR 15)
VP_REF_SEEDS = (0, 1)


def v2v_zero_grad(names):
    """Of the parameter `names`, the V2VNet biases that a BN follows."""
    return tuple(n for n in names
                 if n.endswith('.conv.bias') or n.endswith('.block.0.bias'))


def step_metrics(model, loss):
    """train_run's metrics and gradients after a step: the loss as
    'heatmap_loss', the gradients' global norm, every parameter's
    gradient."""
    grads = {n: p.grad.double().cpu() for n, p in model.named_parameters()}
    metrics = {'heatmap_loss': float(loss),
               'grad_norm': torch.nn.utils.get_total_norm(
                   list(grads.values())).item()}
    return metrics, grads


# InterHand3D ----------------------------------------------------------------

def write_interhand_set(root, name, seed, n, size=320):
    """InterHand2.6M-layout annotation, camera and joint jsons for `n`
    images (JPEGs of `size`^2 with a bright hand region) of two captures,
    hands of each type; returns the file paths."""
    import cv2
    rng = np.random.RandomState(seed)
    images, anns, joints, cams = [], [], {}, {}
    for cap in ('0', '1'):
        cams[cap] = {k: {} for k in ('campos', 'camrot', 'focal',
                                     'princpt')}
        for cam in ('400262', '400263'):
            th = rng.uniform(-0.3, 0.3)
            cams[cap]['campos'][cam] = rng.uniform(-50, 50, 3).tolist()
            cams[cap]['camrot'][cam] = [[np.cos(th), 0, np.sin(th)],
                                        [0, 1, 0],
                                        [-np.sin(th), 0, np.cos(th)]]
            cams[cap]['focal'][cam] = rng.uniform(900, 1100, 2).tolist()
            cams[cap]['princpt'][cam] = [size / 2, size / 2]
        joints[cap] = {}
    os.makedirs(os.path.join(root, 'images'), exist_ok=True)
    for i in range(n):
        cap, cam = str(i % 2), ('400262', '400263')[i // 2 % 2]
        wrist = np.array([rng.uniform(-20, 20), rng.uniform(-20, 20),
                          rng.uniform(700, 900)])
        joints[cap][str(i)] = {'world_coord': (
            wrist + rng.randn(42, 3) * [20, 20, 30]).tolist()}
        file_name = f'images/{name}_{i}.jpg'
        img = rng.randint(0, 80, (size, size, 3), np.uint8)
        img[size // 3:2 * size // 3, size // 3:2 * size // 3] = 220
        cv2.imwrite(os.path.join(root, file_name), img)
        images.append(dict(id=i, file_name=file_name, capture=int(cap),
                           camera=cam, frame_idx=i, width=size,
                           height=size))
        anns.append(dict(id=100 + i, image_id=i, bbox=[
            size / 4, size / 4, size / 2, size / 2],
            joint_valid=np.ones(42, int).tolist(),
            hand_type=('right', 'left', 'interacting')[i % 3],
            hand_type_valid=1))
    paths = {}
    for key, data in (('ann', dict(images=images, annotations=anns,
                                   categories=[dict(id=1, name='hand')])),
                      ('camera', cams), ('joint', joints)):
        paths[key] = os.path.join(root, f'{name}_{key}.json')
        with open(paths[key], 'w') as f:
            json.dump(data, f)
    return paths


def ih_train_run(dtype, device, batch):
    """Two InterHand3D steps (AdamW 2e-4 as the config's loop) of the
    config's model in `dtype` on `batch` (interhand_loop batches):
    train_run's layout, the step's total loss as 'heatmap_loss'."""
    from vitpose_tpu_torch.train.family_loop import adam
    from vitpose_tpu_torch.train.interhand_loop import interhand_step
    model = fam_model('interhand3d', dtype).to(device)
    dt = torch.float64 if dtype == 'float64' else torch.float32
    b = {k: torch.as_tensor(v).to(device, dt) for k, v in batch.items()}
    opt, sched = adam(model.parameters(), 2e-4, lambda c: 2e-4)
    before = snapshot(model)
    m = interhand_step(model, opt, sched, b)
    metrics, grads = step_metrics(model, m['total_loss'])
    interhand_step(model, opt, sched, b)
    after = snapshot(model)
    return metrics, grads, {n: (after[n] - before[n]).double().cpu()
                            for n in after}


def ih_ref_batch(root):
    """InterHand3D's train-ref batch: a loader batch of 2 crops at the
    config's 256x256 (64^3 volumes) from a synthetic set written to
    `root`."""
    from vitpose_tpu_torch.train.interhand_loop import interhand_loader
    from vitpose_tpu_torch.utils.config import apply_options, load_config
    paths = write_interhand_set(root, 'ref', 9, 8)
    opts = [f'data.train.{k}_file={paths[k]}'
            for k in ('ann', 'camera', 'joint')]
    cfg = apply_options(load_config(FAM_CFGS['interhand3d']), opts + [
        f'data.train.img_prefix={root}', 'data.batch_size=2'])
    return {k: torch.as_tensor(v)
            for k, v in next(iter(interhand_loader(cfg))).items()}


def fam_f64_child(jobs_file, out):
    """Each job's run_fn in float64 on the CPU on F64_RUN_THREADS threads,
    the jobs read from `jobs_file`, {name: run} saved to `out` (F64Run's
    child)."""
    torch.set_num_threads(F64_RUN_THREADS)
    jobs = torch.load(jobs_file, weights_only=False)
    runs = {name: fn('float64', 'cpu', batch)
            for name, (fn, batch) in jobs.items()}
    torch.save(runs, out + '.part')
    os.replace(out + '.part', out)


class FamRefs:
    """The family train-refs' jobs, {name: (run_fn, batch)}: InterHand3D's
    ('ih', on ih_ref_batch), HMR's ('mesh', on mesh_ref_batch) and
    VoxelPose's ('vp_seed<s>', on the loop's
    frame arrays of a synthetic Panoptic frame for each of VP_REF_SEEDS),
    made on the host; with `child`, their float64 runs go on in one child
    process (F64Run) from the start, the jobs handed over in a file (the
    spawn pipe would hold this process until the child had imported
    torch). exact(name) returns a job's float64 run (waiting for the
    child, or running it here without one); stop() ends the child."""

    def __init__(self, child=False):
        import shutil
        from vitpose_tpu_torch.data.panoptic_mview import \
            PanopticMviewDataset
        from vitpose_tpu_torch.train.voxelpose_loop import frame_arrays
        root = tempfile.mkdtemp(prefix='famref')
        self.child = self.runs = None
        try:
            self.jobs = {'ih': (ih_train_run, ih_ref_batch(root)),
                         'mesh': (mesh_train_run, mesh_ref_batch(root))}
            seq = write_panoptic_seq(root, 'ref_seq', 0, 1)
            frame = PanopticMviewDataset([seq], cam_names=VP_CAMS,
                                         num_joints=15)[0]
            for seed in VP_REF_SEEDS:
                model = fam_model('voxelpose', seed=seed, **VP_REF_GEOM)
                self.jobs[f'vp_seed{seed}'] = (
                    functools.partial(vp_train_run, seed=seed),
                    frame_arrays(model, frame, VP_HM_SIZE, 10, 2, 200.0))
            if child:
                jobs_file = os.path.join(root, 'jobs.pt')
                torch.save(self.jobs, jobs_file)
                self.child = F64Run(fam_f64_child, (jobs_file,),
                                    cleanup=root)
        finally:
            if self.child is None:
                shutil.rmtree(root, ignore_errors=True)

    def exact(self, name):
        if self.child is None:
            fn, batch = self.jobs[name]
            return fn('float64', 'cpu', batch)
        if self.runs is None:
            self.runs, _ = self.child.result()
        return self.runs[name]

    def stop(self):
        if self.child is not None:
            self.child.stop()


def ih_train_ref(refs):
    """InterHand3D's train-ref (family_ref_runs) on the FamRefs `refs`'
    'ih' job."""
    run_fn, batch = refs.jobs['ih']
    h, w = batch['imgs'].shape[1:3]
    return family_ref_runs(
        'fam-ih-train-ref', run_fn, batch,
        f'InterHand3D-Res50, batch 2 of {w}x{h}',
        exact=lambda: refs.exact('ih'))


def phase_fam_ih(card, refs=None):
    """InterHand3D-Res50 at 256x256, the zoo config at full width (ResNet-50,
    the right and left 3 x 256 deconv stacks to 21 x 64 channels each,
    64^3 volumes), f32 with TF32 convs: inference_interhand_3d_model on a
    64-box image (crops on the card, the volumes, the decode with the
    soft-argmax root depth), timed (the card's busy time by torch.profiler,
    peak memory); CUDA against the CPU on 2 crops, f32 (TF32 off); steps
    at the config's batch of 16, timed, peak memory; the train-ref
    (ih_train_ref); the training CLI for 2 steps on a synthetic InterHand2.6M set, then
    --resume, and the evaluation CLI (MPJPE, MRRPE, Handedness_acc); 0 K1
    and K2."""
    import io
    from vitpose_tpu_torch.api.inference_3d import \
        inference_interhand_3d_model
    from vitpose_tpu_torch.models.interhand3d import backproject_to_camera
    from vitpose_tpu_torch.tools import test as test_cli
    from vitpose_tpu_torch.tools import train as train_cli
    from vitpose_tpu_torch.train.family_loop import adam
    from vitpose_tpu_torch.train.interhand_loop import interhand_step
    from vitpose_tpu_torch.utils.config import load_config
    torch_tf32_defaults()
    reset_counts()
    model = fam_model('interhand3d').cuda().eval()
    rng = np.random.RandomState(30)
    img = rng.randint(0, 255, (720, 1280, 3), np.uint8)
    dets = [{'bbox': [float(x), float(y), 120.0, 110.0]}
            for x, y in zip(rng.uniform(0, 1150, FAM_SERVE_BOXES),
                            rng.uniform(0, 600, FAM_SERVE_BOXES))]

    def serve():
        res = inference_interhand_3d_model(model, img, dets)
        kp = np.stack([r['keypoints_3d'] for r in res])
        backproject_to_camera(kp[..., :3], [1000.0, 1000.0], [640.0, 360.0],
                              [600.0, 620.0])
        return res

    res = serve()
    check(len(res) == FAM_SERVE_BOXES and all(
        r['keypoints_3d'].shape == (42, 4)
        and np.isfinite(r['keypoints_3d']).all() for r in res),
        'fam-ih: serve results')
    serve_ms, serve_peak = wall_steps_ms(serve)
    busy, _ = device_busy_ms(serve)
    # CUDA against the CPU, f32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(3))
    outs = {}
    for dev in ('cuda', 'cpu'):
        model.to(dev)
        outs[dev] = [o.cpu().numpy() for o in model.infer(x.to(dev))]
    ref_err = [rel_err(a, b) for a, b in zip(outs['cuda'], outs['cpu'])]
    check(max(ref_err) <= CNN_HM_RTOL, f'fam-ih: CUDA vs CPU volumes, root '
          f'and hand-type logits differ by {ref_err} of their largest')
    torch_tf32_defaults()
    # steps at the config's batch
    cfg = load_config(FAM_CFGS['interhand3d'])
    bs = cfg['data']['batch_size']
    model.cuda()
    gen = torch.Generator().manual_seed(4)
    batch = dict(
        imgs=torch.rand(bs, 256, 256, 3, generator=gen),
        hm3d=torch.rand(bs, 42, 64, 64, 64, generator=gen) * 0.1,
        hm_weight=torch.ones(bs, 42), rel_root_mm=torch.randn(
            bs, generator=gen) * 50, root_weight=torch.ones(bs),
        hand_type=torch.ones(bs, 2), type_weight=torch.ones(bs))
    batch = {k: v.cuda() for k, v in batch.items()}
    opt, sched = adam(model.parameters(), 2e-4, lambda c: 2e-4)
    step_ms, step_peak = wall_steps_ms(
        lambda: interhand_step(model, opt, sched, batch))
    del model, opt, batch
    torch.cuda.empty_cache()
    report = dict(serve_ms=serve_ms, crops_s=FAM_SERVE_BOXES / serve_ms * 1e3,
                  serve_busy_ms=busy, serve_idle=(None if busy is None else
                                                  1 - busy / serve_ms),
                  serve_peak_gb=serve_peak, ref_err=ref_err,
                  step_ms=step_ms, step_img_s=bs / step_ms * 1e3,
                  step_peak_gb=step_peak)
    report['train_ref'] = ih_train_ref(refs or FamRefs())
    with tempfile.TemporaryDirectory() as root:
        sets = {s: write_interhand_set(root, s, i, n)
                for i, (s, n) in enumerate((('train', 40), ('val', 20)))}
        opts = [f'data.{s}.{k}_file={sets[s][k]}' for s in sets
                for k in ('ann', 'camera', 'joint')]
        opts += [f'data.{s}.img_prefix={root}' for s in sets]
        work = os.path.join(root, 'work')
        args = [FAM_CFGS['interhand3d'], '--work-dir', work, '--max-steps',
                '2', '--cfg-options', 'evaluation.interval=0'] + opts
        walls = []
        for extra in ([], ['--resume']):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                _, metrics = train_cli.main(args + extra)
            walls.append(time.perf_counter() - t0)
        check(all(np.isfinite(v) for v in metrics.values()),
              f'fam-ih: CLI metrics {metrics}')
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = test_cli.main([FAM_CFGS['interhand3d'],
                                   os.path.join(work, 'final.pth'),
                                   '--cfg-options'] + opts)
        eval_s = time.perf_counter() - t0
        check(set(stats) == {'MPJPE', 'MRRPE', 'Handedness_acc'} and all(
            np.isfinite(v) for v in stats.values()),
            f'fam-ih: eval stats {stats}')
    k1, k2 = check_no_kernels('fam-ih')
    report.update(train_cli_s=walls, train_metrics=metrics, eval_s=eval_s,
                  eval_stats={k: float(v) for k, v in stats.items()},
                  k1=k1, k2=k2)
    print(f'fam-ih: InterHand3D-Res50 256x256 (f32, TF32 convs), '
          f'inference_interhand_3d_model on {FAM_SERVE_BOXES} boxes: median '
          f'{serve_ms:.1f} ms = {report["crops_s"]:.1f} crops/s (decode and '
          f'back-projection included), card busy '
          f'{busy if busy is None else round(busy, 1)} ms, peak '
          f'{serve_peak:.2f} GB; CUDA vs CPU (TF32 off, 2 crops): '
          f'{", ".join(f"{e:.2e}" for e in ref_err)} of the largest '
          f'volume / root / hand-type logit; step at batch {bs}: '
          f'{step_ms:.1f} ms = {report["step_img_s"]:.1f} img/s, peak '
          f'{step_peak:.2f} GB; training CLI 2 steps + --resume '
          f'{walls[0]:.1f} + {walls[1]:.1f} s, evaluation CLI {eval_s:.1f} s '
          f'({", ".join(f"{k} {v:.3f}" for k, v in stats.items())}); 0 K1, '
          f'0 K2; on {card}', flush=True)
    return report


# HMR mesh --------------------------------------------------------------------

def write_mesh_sets(root, seed, n=40, size=256):
    """Two mesh npz sets (SMPL and no SMPL), a val set and a Mosh npz, with
    JPEGs of `size`^2; returns their paths."""
    import cv2
    rng = np.random.RandomState(seed)
    out = {}
    for name, k, smpl in (('h36m', n, True), ('coco', n // 2, False),
                          ('val', 24, True)):
        names = [f'{name}_{i}.jpg' for i in range(k)]
        for fn in names:
            img = rng.randint(0, 80, (size, size, 3), np.uint8)
            img[size // 4:3 * size // 4, size // 3:2 * size // 3] = 200
            cv2.imwrite(os.path.join(root, fn), img)
        data = dict(imgname=np.array(names),
                    center=rng.uniform(0.4, 0.6, (k, 2)) * size,
                    scale=rng.uniform(0.9, 1.1, k) * size / 200,
                    part=np.concatenate([rng.uniform(0.3, 0.7, (k, 24, 2))
                                         * size, np.ones((k, 24, 1))], -1),
                    S=np.concatenate([rng.randn(k, 24, 3) * 0.3,
                                      np.ones((k, 24, 1))], -1))
        if smpl:
            data.update(pose=rng.randn(k, 72) * 0.2, shape=rng.randn(k, 10))
        out[name] = os.path.join(root, f'{name}.npz')
        np.savez(out[name], **data)
    out['mosh'] = os.path.join(root, 'mosh.npz')
    np.savez(out['mosh'], pose=rng.randn(50, 72) * 0.2,
             shape=rng.randn(50, 10))
    return out


def mesh_train_run(dtype, device, batch):
    """Two adversarial steps (Adam 2.5e-4 and 1e-4 as the config's loop) of
    the config's generator in `dtype` and a 1024-wide discriminator (f32)
    on `batch`: train_run's layout of the generator (its total loss as
    'heatmap_loss')."""
    from vitpose_tpu_torch.models.mesh import (SMPLDiscriminator,
                                               adversarial_step)
    from vitpose_tpu_torch.train.family_loop import adam
    mesh = fam_model('mesh', dtype).to(device)
    disc = SMPLDiscriminator(1024, generator=torch.Generator()
                             .manual_seed(1)).to(device)
    dt = torch.float64 if dtype == 'float64' else torch.float32
    b = {k: v.to(device, dt) if k == 'imgs' else v.to(device)
         for k, v in batch.items()}
    gopt, gs = adam(mesh.parameters(), 2.5e-4, lambda c: 2.5e-4)
    dopt, ds = adam(disc.parameters(), 1e-4, lambda c: 1e-4)
    before = snapshot(mesh)
    m = adversarial_step(mesh, disc, gopt, dopt, b, gen_sched=gs,
                         disc_sched=ds)
    metrics, grads = step_metrics(mesh, m['gen_loss'])
    adversarial_step(mesh, disc, gopt, dopt, b, gen_sched=gs, disc_sched=ds)
    after = snapshot(mesh)
    return metrics, grads, {n: (after[n] - before[n]).double().cpu()
                            for n in after}


def mesh_ref_batch(root):
    """HMR's train-ref batch: an adversarial loader batch of 2 crops at the
    config's 224x224 from synthetic sets written to `root`."""
    from vitpose_tpu_torch.data.mesh import (MeshAdvLoader, MeshDataset,
                                             MeshMixDataset, MoshDataset)
    from vitpose_tpu_torch.train.mesh_loop import mesh_batch_to_device
    from vitpose_tpu_torch.utils.config import load_config
    sets = write_mesh_sets(root, 32, n=4)
    size = tuple(load_config(FAM_CFGS['mesh'])['data']['image_size'])
    parts = [MeshDataset(sets[k], root + '/', image_size=size)
             for k in ('h36m', 'coco')]
    ld = MeshAdvLoader(MeshMixDataset(parts, [0.6, 0.4]),
                       MoshDataset(sets['mosh']), 2, image_size=size)
    return mesh_batch_to_device(next(iter(ld)), 'cpu')


def mesh_train_ref(refs):
    """HMR's train-ref (family_ref_runs) on the FamRefs `refs`' 'mesh'
    job."""
    run_fn, batch = refs.jobs['mesh']
    h, w = batch['imgs'].shape[1:3]
    return family_ref_runs(
        'fam-mesh-train-ref', run_fn, batch,
        f'HMR-Res50, batch 2 of {w}x{h}', exact=lambda: refs.exact('mesh'))


def phase_fam_mesh(card, refs=None):
    """HMR-Res50 at 224x224, the zoo config at full width (ResNet-50, the
    1024-wide rot6d head, 3 iterations, the seeded linear SMPL surrogate of
    689 vertices), f32 with TF32 convs: inference_mesh_model on a 64-box
    image, timed (busy time, peak memory); CUDA against the CPU on 2 crops
    (TF32 off); adversarial steps at the config's batch of 64, timed, peak
    memory; the train-ref (mesh_train_ref); the training CLI for 2
    steps on synthetic mixed sets and a Mosh prior, then --resume, and the
    evaluation CLI (MPJPE, MPJPE-PA); 0 K1 and K2."""
    import io
    from vitpose_tpu_torch.api.inference_3d import inference_mesh_model
    from vitpose_tpu_torch.models.mesh import (SMPLDiscriminator,
                                               adversarial_step)
    from vitpose_tpu_torch.tools import test as test_cli
    from vitpose_tpu_torch.tools import train as train_cli
    from vitpose_tpu_torch.train.family_loop import adam
    from vitpose_tpu_torch.utils.config import load_config
    torch_tf32_defaults()
    reset_counts()
    mesh = fam_model('mesh').cuda().eval()
    rng = np.random.RandomState(31)
    img = rng.randint(0, 255, (720, 1280, 3), np.uint8)
    dets = [{'bbox': [float(x), float(y), 160.0, 300.0]}
            for x, y in zip(rng.uniform(0, 1100, FAM_SERVE_BOXES),
                            rng.uniform(0, 400, FAM_SERVE_BOXES))]

    def serve():
        return inference_mesh_model(mesh, img, dets)

    res = serve()
    check(len(res) == FAM_SERVE_BOXES and all(
        r['vertices'].shape == (689, 3) and np.isfinite(r['vertices']).all()
        for r in res), 'fam-mesh: serve results')
    serve_ms, serve_peak = wall_steps_ms(serve)
    busy, _ = device_busy_ms(serve)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand(2, 224, 224, 3, generator=torch.Generator().manual_seed(5))
    outs = {}
    for dev in ('cuda', 'cpu'):
        mesh.to(dev)
        with torch.no_grad():
            o = mesh(x.to(dev))
        outs[dev] = {k: v.cpu().numpy() for k, v in o.items()}
    ref_err = {k: rel_err(outs['cuda'][k], outs['cpu'][k])
               for k in outs['cpu']}
    check(max(ref_err.values()) <= CNN_HM_RTOL, f'fam-mesh: CUDA vs CPU '
          f'outputs differ by {ref_err} of their largest')
    torch_tf32_defaults()
    cfg = load_config(FAM_CFGS['mesh'])
    bs = cfg['data']['batch_size']
    mesh.cuda()
    disc = SMPLDiscriminator(1024, generator=torch.Generator()
                             .manual_seed(1)).cuda()
    gen = torch.Generator().manual_seed(6)
    batch = dict(imgs=torch.rand(bs, 224, 224, 3, generator=gen),
                 joints_2d=torch.rand(bs, 24, 2, generator=gen),
                 joints_2d_visible=torch.ones(bs, 24),
                 joints_3d=torch.randn(bs, 24, 3, generator=gen) * 0.3,
                 joints_3d_visible=torch.ones(bs, 24),
                 real_pose=torch.randn(bs, 72, generator=gen) * 0.2,
                 real_shape=torch.randn(bs, 10, generator=gen))
    batch = {k: v.cuda() for k, v in batch.items()}
    gopt, gs = adam(mesh.parameters(), 2.5e-4, lambda c: 2.5e-4)
    dopt, ds = adam(disc.parameters(), 1e-4, lambda c: 1e-4)
    mean = mesh.mesh_head.init_pose.clone()
    step_ms, step_peak = wall_steps_ms(lambda: adversarial_step(
        mesh, disc, gopt, dopt, batch, gen_sched=gs, disc_sched=ds))
    check(torch.equal(mesh.mesh_head.init_pose, mean),
          'fam-mesh: the mean parameters moved')
    del mesh, disc, gopt, dopt, batch
    torch.cuda.empty_cache()
    report = dict(serve_ms=serve_ms, crops_s=FAM_SERVE_BOXES / serve_ms * 1e3,
                  serve_busy_ms=busy, serve_peak_gb=serve_peak,
                  ref_err=ref_err, step_ms=step_ms,
                  step_img_s=bs / step_ms * 1e3, step_peak_gb=step_peak)
    with tempfile.TemporaryDirectory() as root:
        sets = write_mesh_sets(root, 32)
        report['train_ref'] = mesh_train_ref(refs or FamRefs())
        opts = ['data.train.configs=' + repr([
                    {'ann_file': sets[k], 'img_prefix': root + '/'}
                    for k in ('h36m', 'coco')]),
                f'data.train.adv_ann_file={sets["mosh"]}',
                f'data.val.ann_file={sets["val"]}',
                f'data.val.img_prefix={root}/', 'data.batch_size=16']
        work = os.path.join(root, 'work')
        args = [FAM_CFGS['mesh'], '--work-dir', work, '--max-steps', '2',
                '--cfg-options', 'evaluation.interval=0'] + opts
        walls = []
        for extra in ([], ['--resume']):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                _, metrics = train_cli.main(args + extra)
            walls.append(time.perf_counter() - t0)
        check(all(np.isfinite(v) for v in metrics.values()),
              f'fam-mesh: CLI metrics {metrics}')
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = test_cli.main([FAM_CFGS['mesh'],
                                   os.path.join(work, 'final.pth'),
                                   '--cfg-options'] + opts)
        eval_s = time.perf_counter() - t0
        check(set(stats) == {'MPJPE', 'MPJPE-PA'} and all(
            np.isfinite(v) for v in stats.values()),
            f'fam-mesh: eval stats {stats}')
    k1, k2 = check_no_kernels('fam-mesh')
    report.update(train_cli_s=walls, train_metrics=metrics, eval_s=eval_s,
                  eval_stats={k: float(v) for k, v in stats.items()},
                  k1=k1, k2=k2)
    print(f'fam-mesh: HMR-Res50 224x224 (f32, TF32 convs), '
          f'inference_mesh_model on {FAM_SERVE_BOXES} boxes: median '
          f'{serve_ms:.1f} ms = {report["crops_s"]:.1f} crops/s, card busy '
          f'{busy if busy is None else round(busy, 1)} ms, peak '
          f'{serve_peak:.2f} GB; CUDA vs CPU (TF32 off, 2 crops), largest '
          f'{max(ref_err.values()):.2e} of an output\'s largest; '
          f'adversarial step at batch {bs}: {step_ms:.1f} ms = '
          f'{report["step_img_s"]:.1f} img/s, peak {step_peak:.2f} GB, the '
          f'mean parameters unmoved; training CLI 2 steps + --resume '
          f'{walls[0]:.1f} + {walls[1]:.1f} s, evaluation CLI {eval_s:.1f} s '
          f'({", ".join(f"{k} {v:.2f}" for k, v in stats.items())}); 0 K1, '
          f'0 K2; on {card}', flush=True)
    return report


# VoxelPose -------------------------------------------------------------------

def vp_look_at(pos):
    """Panoptic extrinsics (X_cam = R X_world + t, cm, y down) of a camera
    at `pos` looking at the scene's mid-height."""
    z = np.array([0.0, -90.0, 0.0]) - pos
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    r = np.stack([x, np.cross(z, x), z])
    return r, -r @ pos


def write_panoptic_seq(root, name, seed, frames):
    """A CMU-Panoptic sequence: the 5 HD cameras of the config (1920x1080,
    distortion) on a circle of 7 m around the scene, `frames` coco19 body
    files of VP_PEOPLE people standing 1-1.7 m tall."""
    rng = np.random.RandomState(seed)
    seq = os.path.join(root, name)
    os.makedirs(os.path.join(seq, 'hdPose3d_stage1_coco19'))
    cams = []
    for i, cam in enumerate(VP_CAMS):
        ang = 2 * np.pi * i / len(VP_CAMS) + 0.3
        r, t = vp_look_at(np.array([700 * np.cos(ang), -150.0,
                                    700 * np.sin(ang)]))
        cams.append(dict(name=cam, K=[[1400.0, 0, 960], [0, 1400.0, 540],
                                      [0, 0, 1]], R=r.tolist(),
                         t=t.reshape(3, 1).tolist(), resolution=[1920, 1080],
                         distCoef=(rng.randn(5) * [0.05, 0.01, 1e-3, 1e-3,
                                                   1e-3]).tolist()))
    with open(os.path.join(seq, f'calibration_{name}.json'), 'w') as f:
        json.dump({'cameras': cams}, f)
    for fi in range(frames):
        bodies = []
        for pid in range(VP_PEOPLE):
            base = np.array([rng.uniform(-250, 250), 0.0,
                             rng.uniform(-250, 150)])
            j = base + np.stack([rng.uniform(-25, 25, 19),
                                 -rng.uniform(0, 170, 19),
                                 rng.uniform(-25, 25, 19)], 1)
            j[2] = base + [0, -95, 0]
            bodies.append(dict(id=pid, joints19=np.concatenate(
                [j, np.ones((19, 1))], 1).ravel().tolist()))
        with open(os.path.join(seq, 'hdPose3d_stage1_coco19',
                               f'body3DScene_{fi:08d}.json'), 'w') as f:
            json.dump({'bodies': bodies}, f)
    return seq


def vp_shape_centers(model, heat, cams, keep=5):
    """Shift the centre net's output bias so that about `keep` voxels of
    the frame's centre volume pass the config's threshold (random weights
    put the whole volume on one side of it, and the forward would then
    propose no one or the first max_people voxels of a flat volume);
    returns the shift."""
    with torch.no_grad():
        vol = model.center_volume(heat, cams).flatten()
        shift = model.center_threshold - float(vol.topk(keep).values[-1]) \
            + 1e-3
        model.human_detector.center_net.output_layer.bias += shift
    return shift


def vp_train_run(dtype, device, fa, seed=0):
    """Two VoxelPose steps (Adam 1e-4, the config's loop) of the config's
    widths at VP_REF_GEOM, weights from `seed`, in `dtype` on the frame
    arrays `fa`: train_run's layout (the step's total loss as
    'heatmap_loss')."""
    from vitpose_tpu_torch.train.family_loop import adam
    from vitpose_tpu_torch.train.voxelpose_loop import (stack_frames,
                                                        voxelpose_step)
    model = fam_model('voxelpose', dtype, seed, **VP_REF_GEOM).to(device)
    batch = stack_frames([fa], device)
    opt, sched = adam(model.parameters(), 1e-4, lambda c: 1e-4)
    before = snapshot(model)
    m = voxelpose_step(model, opt, sched, batch)
    metrics, grads = step_metrics(model, m['total_loss'])
    voxelpose_step(model, opt, sched, batch)
    after = snapshot(model)
    return metrics, grads, {n: (after[n] - before[n]).double().cpu()
                            for n in after}


def vp_train_ref(refs, seed):
    """VoxelPose's train-ref (family_ref_runs) at the config's widths on
    VP_REF_GEOM's grid, weights from `seed`, on the FamRefs `refs`' frame
    arrays (10 candidate slots): the centre net and the pose net, which
    separate losses train, each held against its own largest gradient;
    the run that hold_train_ref holds goes through ATen's own CUDA
    convolutions, the one through cuDNN's by family_holds."""
    name = f'vp_seed{seed}'
    run_fn, fa = refs.jobs[name]
    names = [n for n, _ in fam_model('voxelpose', **VP_REF_GEOM)
             .named_parameters()]
    return family_ref_runs(
        'fam-vp-train-ref', run_fn, fa,
        f'VoxelPose (V2VNets 32 wide, weights seed {seed}), 20x20x8 space, '
        '16^3 cubes, 10 candidate slots', zero_grad=v2v_zero_grad(names),
        zero_floor=VP_ZERO_FLOOR, groups=VP_REF_GROUPS, cudnn_off=True,
        exact=lambda: refs.exact(name))


def phase_fam_vp(card, refs=None):
    """VoxelPose at the config's sizes (space 8 x 8 x 2 m in 80x80x20
    voxels, 2 m cubes of 64^3, V2VNets 32 wide, 15 joints, 10 proposals at
    most), f32 with TF32 convs, on a synthetic 5-view Panoptic frame of 3
    people with heatmaps painted at the GT projections (15 x 128 x 240 a
    view), the centre net's output bias shifted so that about 5 voxels
    pass the config's threshold (vp_shape_centers): the forward with its
    host proposals, timed (the projections
    against the centre and pose V2VNets by CUDA events, peak memory);
    CUDA against the CPU (TF32 off): the centre volume, and the joints of 2
    proposals given the same proposals; 2 timed steps (10 candidate cubes,
    peak memory); the train-ref (vp_train_ref) on each of VP_REF_SEEDS;
    the training CLI for 2 steps, then
    --resume, and the evaluation CLI (recall, MPJPE, AP and AR; threshold
    0, so that 10 proposals a frame reach the pose net); 0 K1 and K2."""
    import io
    from vitpose_tpu_torch.data.panoptic_mview import PanopticMviewDataset
    from vitpose_tpu_torch.models.voxelpose import (CuboidCenterHead,
                                                    camera_tensors)
    from vitpose_tpu_torch.tools import test as test_cli
    from vitpose_tpu_torch.tools import train as train_cli
    from vitpose_tpu_torch.train.family_loop import adam
    from vitpose_tpu_torch.train.voxelpose_loop import (
        frame_arrays, gt_projected_heatmaps, heatmap_frame_cameras,
        stack_frames, voxelpose_step)
    torch_tf32_defaults()
    reset_counts()
    with tempfile.TemporaryDirectory() as root:
        seqs = {s: write_panoptic_seq(root, s, i, 2)
                for i, s in enumerate(('train_seq', 'val_seq'))}
        ds = PanopticMviewDataset([seqs['train_seq']], cam_names=VP_CAMS,
                                  num_joints=15)
        frame = ds[0]
        hm_size = VP_HM_SIZE
        cams = heatmap_frame_cameras(frame['cameras'], hm_size)
        heat = torch.from_numpy(gt_projected_heatmaps(frame, cams, 15,
                                                      hm_size)).cuda()
        model = fam_model('voxelpose').cuda().eval()
        shift = vp_shape_centers(model, heat, cams)
        people = model(heat, cams)
        check(len(people) >= 1 and all(np.isfinite(j).all()
                                       for j, _ in people),
              f'fam-vp: {len(people)} people')
        fwd_ms, fwd_peak = wall_steps_ms(lambda: model(heat, cams))
        # the forward's parts by CUDA events, the calls forward makes
        cp = camera_tensors(cams, 'cuda')
        with torch.no_grad():
            proposals = CuboidCenterHead.get_proposals(
                model.center_volume(heat, cams).cpu().numpy(),
                model.space_grid().numpy(), model.max_people,
                model.center_threshold)
        centers = torch.as_tensor(np.stack([c for c, _ in proposals]),
                                  device='cuda')
        with torch.no_grad():
            space = model.space_grid('cuda')
            vol_s = model._volume(heat, cp, space)[None]
            vol_c, grids = project(model, heat, cp, centers)
            parts = {name: time_ms(fn, calls=1, rounds=3, warmup=1)
                     for name, fn in (
                         ('project_space',
                          lambda: model._volume(heat, cp, space)),
                         ('center_v2v', lambda: model.center(vol_s)),
                         ('project_cubes',
                          lambda: project(model, heat, cp, centers)),
                         ('pose_v2v', lambda: model.pose(vol_c, grids)))}
            del vol_s, vol_c, grids
        # CUDA against the CPU, TF32 off: the centre volume, and the joints
        # of 2 proposals given the same proposals
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        outs = {}
        for dev in ('cuda', 'cpu'):
            model.to(dev)
            h = heat.to(dev)
            with torch.no_grad():
                outs[dev] = (model.center_volume(h, cams).cpu().numpy(),
                             model.pose_joints(h, camera_tensors(cams, dev),
                                               centers[:2].to(dev))
                             .cpu().numpy())
        ref_err = [rel_err(a, b) for a, b in zip(outs['cuda'], outs['cpu'])]
        check(ref_err[0] <= CNN_HM_RTOL and ref_err[1] <= 1e-4,
              f'fam-vp: CUDA vs CPU centre volume / joints differ by '
              f'{ref_err}')
        by_dev = [CuboidCenterHead.get_proposals(
            outs[d][0], model.space_grid().numpy(), model.max_people,
            model.center_threshold) for d in ('cuda', 'cpu')]
        same_props = len(by_dev[0]) == len(by_dev[1]) and all(
            np.array_equal(a[0], b[0]) for a, b in zip(*by_dev))
        torch_tf32_defaults()
        # steps: the loop's frame arrays, 10 candidate slots
        model.cuda()
        fa = frame_arrays(model, frame, hm_size, 10, 2, 200.0)
        batch = stack_frames([fa], 'cuda')
        opt, sched = adam(model.parameters(), 1e-4, lambda c: 1e-4)
        step_ms, step_peak = wall_steps_ms(
            lambda: voxelpose_step(model, opt, sched, batch))
        del model, opt, batch, heat
        torch.cuda.empty_cache()
        refs = refs or FamRefs()
        train_ref = {f'seed_{seed}': vp_train_ref(refs, seed)
                     for seed in VP_REF_SEEDS}
        opts = [f'data.{s}.seq_dirs=("{seqs[s + "_seq"]}",)'
                for s in ('train', 'val')]
        work = os.path.join(root, 'work')
        args = [FAM_CFGS['voxelpose'], '--work-dir', work, '--max-steps',
                '2', '--cfg-options', 'evaluation.interval=0'] + opts
        walls = []
        for extra in ([], ['--resume']):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                _, metrics = train_cli.main(args + extra)
            walls.append(time.perf_counter() - t0)
        check(all(np.isfinite(v) for v in metrics.values()),
              f'fam-vp: CLI metrics {metrics}')
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            # threshold 0: the max_people proposals all go through the pose
            # net (the 2-step weights' centre volume is not shaped)
            stats = test_cli.main([FAM_CFGS['voxelpose'],
                                   os.path.join(work, 'final.pth'),
                                   '--cfg-options', 'model.center_threshold=0.0']
                                  + opts)
        eval_s = time.perf_counter() - t0
        check('mAP' in stats and 'RECALL 500mm' in stats,
              f'fam-vp: eval stats {stats}')
    k1, k2 = check_no_kernels('fam-vp')
    report = dict(forward_ms=fwd_ms, forward_peak_gb=fwd_peak,
                  proposals=len(people), center_bias_shift=shift,
                  parts_ms=parts, ref_err=ref_err,
                  same_proposals=same_props, step_ms=step_ms,
                  step_peak_gb=step_peak, train_ref=train_ref,
                  train_cli_s=walls, train_metrics=metrics, eval_s=eval_s,
                  eval_stats={k: float(v) for k, v in stats.items()},
                  k1=k1, k2=k2)
    print(f'fam-vp: VoxelPose (80x80x20 space, 64^3 cubes, V2VNets 32 wide; '
          f'f32, TF32 convs), 5 views of 15x128x240 heatmaps, '
          f'{len(people)} proposals: forward median {fwd_ms:.1f} ms, peak '
          f'{fwd_peak:.2f} GB; by CUDA events ' + ', '.join(
              f'{k} {v:.2f} ms' for k, v in parts.items())
          + f'; CUDA vs CPU (TF32 off): centre volume {ref_err[0]:.2e}, '
          f'joints of 2 proposals {ref_err[1]:.2e} of the largest, the '
          f'proposals equal: {same_props}; step (10 candidate cubes): '
          f'{step_ms:.1f} ms, peak {step_peak:.2f} GB; training CLI 2 steps '
          f'+ --resume {walls[0]:.1f} + {walls[1]:.1f} s, evaluation CLI '
          f'{eval_s:.1f} s (mAP {stats["mAP"]:.3f}, recall '
          f'{stats["RECALL 500mm"]:.3f}); 0 K1, 0 K2; on {card}',
          flush=True)
    return report


def project(model, heat, cp, centers):
    """The cubes' volumes [P, K, X, Y, Z] of `centers` and their grids."""
    from vitpose_tpu_torch.models.voxelpose import project_heatmaps_to_voxels
    grids = model.cube_grids(centers)
    vols = project_heatmaps_to_voxels(heat, cp, grids)
    return vols.permute(0, 4, 1, 2, 3), grids


# demos and the multi-task model -------------------------------------------

def phase_fam_apps(card):
    """Both family demos on the card with the zoo configs and seeded
    weights (InterHand3D's drawing swapped for lifted_pose_writer: the card
    machine has no matplotlib), and MultiTaskModel on a ResNet-50 trunk
    with a heatmap head (17 joints, SimpleBaseline's 3 x 256 deconvs) and a
    regression head at 256x192, batch 32: its forward and one step of the
    summed losses (`multitask_loss`), finite, parameters moved; 0 K1 and
    K2."""
    import cv2
    import io
    from vitpose_tpu_torch.demo import interhand3d_img_demo, mesh_img_demo
    from vitpose_tpu_torch.models.heads import HeatmapHead
    from vitpose_tpu_torch.models.heads_extra import RegressionHead
    from vitpose_tpu_torch.models.losses import (joints_mse_loss,
                                                 smooth_l1_loss)
    from vitpose_tpu_torch.models.multitask import (MultiTaskModel,
                                                    multitask_loss)
    from vitpose_tpu_torch.models.resnet import ResNet
    torch_tf32_defaults()
    reset_counts()
    report = {}
    draw = interhand3d_img_demo.vis_pose_result_3d
    interhand3d_img_demo.vis_pose_result_3d = lifted_pose_writer
    try:
        with tempfile.TemporaryDirectory() as root:
            rng = np.random.RandomState(33)
            img = rng.randint(0, 80, (480, 640, 3), np.uint8)
            img[120:360, 220:420] = 220
            path = os.path.join(root, 'img.jpg')
            cv2.imwrite(path, img)
            out = os.path.join(root, 'vis')
            for name, module, args in (
                    ('interhand3d_img_demo', interhand3d_img_demo,
                     ['--hand-box', '220,120,200,240', '--focal',
                      '1000,1000', '--princpt', '320,240']),
                    ('mesh_img_demo', mesh_img_demo,
                     ['--bbox', '200,60,240,380'])):
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    res, written = module.main([path, '--out-img-root', out]
                                               + args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                check(len(res) == 1 and os.path.getsize(written) > 0,
                      f'fam-apps: {name} output')
                report[name] = dict(wall_s=wall)
    finally:
        interhand3d_img_demo.vis_pose_result_3d = draw
    gen = torch.Generator().manual_seed(34)
    model = MultiTaskModel(ResNet(50, generator=gen), [
        HeatmapHead(2048, 17, (256, 256, 256), (4, 4, 4), generator=gen),
        RegressionHead(2048, 17, generator=gen)]).cuda().train()
    x = torch.rand(32, 256, 192, 3, generator=gen).cuda()
    targets = [torch.rand(32, 17, 64, 48, generator=gen).cuda(),
               torch.rand(32, 17, 2, generator=gen).cuda()]
    weights = [torch.ones(32, 17, device='cuda')] * 2
    opt = torch.optim.Adam(model.parameters(), 1e-4)
    before = [p.detach().clone() for p in model.parameters()]
    t0 = time.perf_counter()
    outs = model(x)
    total, losses = multitask_loss(outs, targets, weights,
                                   [joints_mse_loss, smooth_l1_loss],
                                   [1.0, 0.5])
    opt.zero_grad()
    total.backward()
    opt.step()
    torch.cuda.synchronize()
    mt_ms = (time.perf_counter() - t0) * 1e3
    check(outs[0].shape == (32, 17, 64, 48) and outs[1].shape == (32, 17, 2)
          and np.isfinite(float(total.detach())),
          'fam-apps: multi-task outputs')
    moved = sum(not torch.equal(a, b)
                for a, b in zip(before, model.parameters()))
    check(moved == len(before), f'fam-apps: {moved} of {len(before)} '
          'multi-task parameters moved')
    k1, k2 = check_no_kernels('fam-apps')
    report.update(multitask_step_ms=mt_ms, multitask_losses={
        k: float(v) for k, v in losses.items()}, k1=k1, k2=k2)
    print(f'fam-apps: interhand3d_img_demo {report["interhand3d_img_demo"]["wall_s"]:.2f} s, '
          f'mesh_img_demo {report["mesh_img_demo"]["wall_s"]:.2f} s (main, '
          f'model build and weights included); MultiTaskModel (ResNet-50, '
          f'heatmap + regression heads, 256x192, batch 32, f32, TF32 '
          f'convs): one step {mt_ms:.1f} ms (first, with cuDNN\'s '
          f'selection), losses ' + ', '.join(
              f'{k} {float(v):.4f}' for k, v in losses.items())
          + f'; 0 K1, 0 K2; on {card}', flush=True)
    return report


def run_fam_phases(card, refs=None):
    """The one-config families' phases in order, each timed; `refs` the
    train-refs' FamRefs (made here, their float64 runs in this process,
    where not given)."""
    refs = refs or FamRefs()
    return run_phases('fam', (
        ('ih', lambda c: phase_fam_ih(c, refs)),
        ('mesh', lambda c: phase_fam_mesh(c, refs)),
        ('vp', lambda c: phase_fam_vp(c, refs)), ('apps', phase_fam_apps)),
        card)


def fam_launches(fam, key):
    """A kernel's launches on each one-config family path: none."""
    return {f'fam_{name}': fam[name][key] for name in ('ih', 'mesh', 'vp',
                                                       'apps')}


# --- dist: training across processes (parallel/) -----------------------------

DIST_BATCH = 64                       # the world-1 step: the COCO-B batch
DIST_HR_BATCH = 8                     # HRNet-W32's float64 step, 4 a rank
DIST_TIMED_STEPS = 2                  # timed steps per turn
DIST_SAMPLES = 256                    # gradient elements compared per tensor
# two bf16 ranks against one process: the per-sample work is the same, but
# the GEMMs of half a batch may tile and sum in another order, and the
# gradients of the halves are summed by the all-reduce: each gradient
# tensor's norm and sampled elements within DIST_GRAD_RTOL of the tensor's
# largest (eight bf16 steps; the first card run measured 0.0075, two), or
# of DIST_GRAD_FLOOR of the largest of all, for gradients of rounding size;
# the loss and grad_norm within DIST_LOSS_RTOL, acc_pose within
# DIST_ACC_ATOL (an argmax tie may fall the other way)
DIST_GRAD_RTOL = 2.0 ** -5
DIST_GRAD_FLOOR = 1e-3
DIST_LOSS_RTOL = 1e-3
DIST_ACC_ATOL = 0.02
# HRNet-W32 in float64 over two ranks (global BN) against one process
DIST_F64_RTOL = 1e-8
DIST_F64_FLOOR = 1e-6
DIST_CHILD_TIMEOUT_S = 240


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def grad_summary(model):
    """Per parameter with a gradient: (its norm, DIST_SAMPLES of its
    elements at fixed positions), in float64 on the host."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.detach().reshape(-1).double()
        idx = torch.linspace(0, g.numel() - 1, min(DIST_SAMPLES, g.numel()),
                             device=g.device).long()
        out[name] = (g.norm().item(), g[idx].cpu())
    return out


def compare_grads(what, got, want, rtol, floor):
    """The largest difference of the per-tensor norms and sampled elements
    of two grad_summary()s, relative to each tensor's largest sampled
    element or `floor` times the largest of all; fails beyond `rtol`."""
    top = max(sample.abs().max().item() for _, sample in want.values())
    worst = (0.0, None)
    for name, (norm, sample) in want.items():
        n2, s2 = got[name]
        scale = max(sample.abs().max().item(), floor * top, 1e-300)
        err = max(abs(n2 - norm), (s2 - sample).abs().max().item()) / scale
        check(err <= rtol, f'{what}: gradient of {name} {err:.3g} from one '
              f'process (limit {rtol})')
        worst = max(worst, (err, name))
    return worst


def dist_vit_step(layout=None, zero=False, batch_rows=None):
    """One full-width ViTPose-B bf16 step (K1 + K2, drop_path 0.3, COCO-B
    AdamW) from init_pose_model's seed on the seeded DIST_BATCH batch (this
    rank's rows of it under `layout`), ZeRO-1 where `zero`: (state, step,
    batch, metrics of the first step, its gradients' summary)."""
    from vitpose_tpu_torch.parallel.mesh import (activate, average_metrics,
                                                 shard_rows)
    from vitpose_tpu_torch.parallel.zero import zero1
    state, step, preprocess, info = train_setup(SERVE_CFG, 'cuda')
    batch = preprocess(*train_inputs(0, DIST_BATCH, info, 'cuda'))
    with activate(layout):
        if zero:
            zero1(state.optimizer)
        if layout is not None:
            batch = {k: v.contiguous() for k, v in shard_rows(batch).items()}
        gen = torch.Generator(device='cuda').manual_seed(7)
        m = average_metrics(step(state, batch, gen))
    return (state, step, batch, {k: v.item() for k, v in m.items()},
            grad_summary(state.model))


def dist_hrnet_step(layout=None):
    """One HRNet-W32 step in float64 (its config's model, BN after every
    conv) on DIST_HR_BATCH seeded crops (this rank's rows under `layout`):
    (metrics, gradients' summary, BN running statistics after it)."""
    from vitpose_tpu_torch.data.dataset_info import DatasetInfo
    from vitpose_tpu_torch.data.pipeline import make_preprocess_fn
    from vitpose_tpu_torch.parallel.mesh import (activate, average_metrics,
                                                 shard_rows)
    from vitpose_tpu_torch.train.loop import build_train_state
    from vitpose_tpu_torch.train.step import make_train_step
    from vitpose_tpu_torch.utils.config import load_config
    cfg = load_config(HRNET_CFG)
    cfg['model'] = cnn_model_dict(HRNET_CFG, 'float64')
    state = build_train_state(cfg, STEPS_PER_EPOCH, 'cuda')
    state.model.double()
    batch = make_preprocess_fn(cfg['data']['image_size'],
                               cfg['data']['heatmap_size'], use_udp=False)(
        *train_inputs(1, DIST_HR_BATCH, DatasetInfo.load('coco'), 'cuda'))
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()}
    with activate(layout):
        if layout is not None:
            batch = {k: v.contiguous() for k, v in shard_rows(batch).items()}
        m = average_metrics(make_train_step(state.model)(
            state, batch, torch.Generator(device='cuda')))
    stats = {n: b.detach().cpu() for n, b in state.model.named_buffers()
             if 'running' in n}
    return ({k: v.item() for k, v in m.items()},
            grad_summary(state.model), stats)


def dist_child(rank, root):
    """One of the two ranks of phase_dist on the one card: a gloo group over
    a file store in `root` (NCCL takes one rank a card), CUDA tensors; the
    ViTPose-B step with ZeRO-1 and the HRNet-W32 float64 step on this rank's
    half of each batch; results to root/rank<r>.pt."""
    import datetime
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed(device='cpu', backend='gloo',
                     init_method='file://' + os.path.join(root, 'store'),
                     rank=rank, world_size=2,
                     timeout=datetime.timedelta(
                         seconds=DIST_CHILD_TIMEOUT_S))
    layout = make_mesh(n_data=2)
    reset_counts()
    state, _, _, vit_m, vit_g = dist_vit_step(layout, zero=True)
    launches = (fused_attention.launches, fused_attention_bwd.launches)
    owned = len(state.optimizer.state)
    del state
    torch.cuda.empty_cache()
    hr = dist_hrnet_step(layout)
    torch.save(dict(vit=(vit_m, vit_g), launches=launches, owned=owned,
                    hrnet=hr), os.path.join(root, f'rank{rank}.pt'))
    torch.distributed.destroy_process_group()


def timed_turns(runs, steps=DIST_TIMED_STEPS):
    """Median ms per step of each named run() in turns (a, b, b, a)."""
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def phase_dist(card):
    """World 1 over NCCL (init_distributed; the runner's data-parallel hook
    and ZeRO-1 on a data group of one process, so that their collectives
    run) against the plain step; then two gloo ranks on the one card,
    each on half of each batch, against one process."""
    import multiprocessing
    import shutil
    import torch.distributed as dist
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.parallel import init_distributed
    from vitpose_tpu_torch.parallel.mesh import Layout, activate
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix='dist')
    ctx = multiprocessing.get_context('spawn')
    # the two ranks start first: they take seconds to reach the card
    kids = [ctx.Process(target=dist_child, args=(r, root), daemon=True)
            for r in range(2)]
    for k in kids:
        k.start()
    try:
        rank, world = init_distributed(
            device='cuda', init_method=f'tcp://127.0.0.1:{free_port()}',
            rank=0, world_size=1)
        check((rank, world, dist.get_backend()) == (0, 1, 'nccl'),
              f'init_distributed gave {rank, world, dist.get_backend()}')
        layout = Layout(groups={'data': dist.group.WORLD})
        plain, p_step, p_batch, p_m, p_g = dist_vit_step()
        reset_counts()
        dp, d_step, d_batch, d_m, d_g = dist_vit_step(layout, zero=True)
        launches = (fused_attention.launches, fused_attention_bwd.launches)
        check(launches == (12, 12), f'the world-1 data-parallel step '
              f'launched K1, K2 {launches} times, expected 12 each')
        check(hasattr(dp.optimizer, 'vtp_zero'), 'ZeRO-1 did not split')
        diff = max((a - b).abs().max().item() for a, b in
                   zip(plain.model.parameters(), dp.model.parameters()))
        check(diff == 0.0, f'world-1 data-parallel step: parameters '
              f'{diff:.3g} from the plain step')
        check(p_m == d_m, f'world-1 metrics {d_m} != plain {p_m}')
        gen = torch.Generator(device='cuda')

        def run_dp():
            with activate(layout):
                d_step(dp, d_batch, gen)
        ms = timed_turns({'plain': lambda: p_step(plain, p_batch, gen),
                          'dp': run_dp})
        del plain, dp
        torch.cuda.empty_cache()
        dist.destroy_process_group()
        hr_one = dist_hrnet_step()
        deadline = time.perf_counter() + DIST_CHILD_TIMEOUT_S
        for k in kids:
            k.join(max(deadline - time.perf_counter(), 1))
        codes = [k.exitcode for k in kids]
        check(codes == [0, 0], f'the two gloo ranks on the card exited '
              f'with {codes}')
        r0, r1 = (torch.load(os.path.join(root, f'rank{r}.pt'),
                             weights_only=False) for r in range(2))
    finally:
        for k in kids:
            if k.is_alive():
                k.terminate()
                k.join()
        shutil.rmtree(root, ignore_errors=True)
    for r in (r0, r1):
        check(r['launches'] == (12, 12), f'a rank launched K1, K2 '
              f'{r["launches"]} times in its step, expected 12 each')
    n_params = len(p_g)
    check(0 < r0['owned'] < n_params and r0['owned'] + r1['owned']
          == n_params, f'ZeRO-1 state split {r0["owned"]} + '
          f'{r1["owned"]} of {n_params}')
    vit_m, vit_g = r0['vit']
    for k, v in p_m.items():
        tol = (DIST_ACC_ATOL if k == 'acc_pose'
               else DIST_LOSS_RTOL * abs(v))
        check(abs(vit_m[k] - v) <= tol, f'two ranks {k} {vit_m[k]} against '
              f'one process {v}')
    vit_err = compare_grads('two ranks ViTPose-B', vit_g, p_g,
                            DIST_GRAD_RTOL, DIST_GRAD_FLOOR)
    hr_m, hr_g, hr_stats = r0['hrnet']
    for k, v in hr_one[0].items():
        tol = (DIST_ACC_ATOL if k == 'acc_pose'
               else DIST_F64_RTOL * abs(v) + 1e-12)
        check(abs(hr_m[k] - v) <= tol, f'two ranks HRNet-W32 {k} {hr_m[k]} '
              f'against one process {v}')
    hr_err = compare_grads('two ranks HRNet-W32 f64', hr_g, hr_one[1],
                           DIST_F64_RTOL, DIST_F64_FLOOR)
    stat_err = max(((hr_stats[n] - s).abs().max()
                    / s.abs().max().clamp_min(1e-30)).item()
                   for n, s in hr_one[2].items())
    check(stat_err <= DIST_F64_RTOL, f'two ranks HRNet-W32 BN statistics '
          f'{stat_err:.3g} from one process')
    wall = time.perf_counter() - t_phase
    print(f'dist: world 1 over NCCL (init_distributed), ViTPose-B 256x192 '
          f'bf16 batch {DIST_BATCH} with the data-parallel hook and ZeRO-1 '
          f'on: {launches[0]} K1 + {launches[1]} K2 launches a step, '
          f'parameters equal to the plain step\'s; step {ms["dp"]:.1f} ms '
          f'beside the plain step\'s {ms["plain"]:.1f} ms on {card}',
          flush=True)
    print(f'dist: two gloo ranks on the one card, CUDA tensors, half of '
          f'each batch a rank: ViTPose-B (K1 + K2, ZeRO-1: '
          f'{r0["owned"]} + {r1["owned"]} of {n_params} tensors\' AdamW '
          f'state) gradients within {vit_err[0]:.3g} of one process (limit '
          f'{DIST_GRAD_RTOL:.3g}; the farthest {vit_err[1]}), losses within '
          f'{DIST_LOSS_RTOL}; HRNet-W32 float64, BN over both ranks: '
          f'gradients within {hr_err[0]:.3g}, BN statistics within '
          f'{stat_err:.3g} (limit {DIST_F64_RTOL}); phase {wall:.1f} s',
          flush=True)
    return {'world1': {'k1': launches[0], 'k2': launches[1],
                       'step_ms': ms['dp'], 'plain_step_ms': ms['plain']},
            'two_ranks': {'vit_grad_err': vit_err[0],
                          'vit_grad_farthest': vit_err[1],
                          'hrnet_grad_err': hr_err[0],
                          'hrnet_bn_err': stat_err,
                          'zero1_owned': [r0['owned'], r1['owned']],
                          'k1': r0['launches'][0], 'k2': r0['launches'][1]},
            'wall_s': wall}


# tools: the root CLIs and the JAX functions that no config reaches (items
# 14 and 15), each through its main(argv) on the card at full ViT-B width,
# on a synthetic COCO set of TOOLS_IMAGES 480x640 images (4 boxes each, 14
# GT persons: one training step of 12 for overfit_sanity, two val batches
# of 7 for the int8 sweep)
TOOLS_IMAGES = 4
TOOLS_BATCH = 64                      # the timed tools' batch
TOOLS_ITERS = 2                       # timed calls per timing tool
TOOLS_SWEEP_GRID = ((0, 0), (1, 1))   # of JAX's eight (k_first, k_last)
TOOLS_HYBRID_TOL = 1e-2               # K1 vs plain attention, 12 bf16 blocks


def quiet(fn, *args, **kw):
    """fn(*args, **kw) with its standard output kept out of the log; returns
    (result, output)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def tool_run(name, launches, fn, *args, **kw):
    """Run one tool path from zero counts; record its K1 and K2 launches in
    `launches[name]`, check its launch shapes; returns (result, output,
    wall s)."""
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    reset_counts()
    t0 = time.perf_counter()
    out, text = quiet(fn, *args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches[name] = (fused_attention.launches, fused_attention_bwd.launches)
    check_shapes_held(f'tools {name}')
    return out, text, wall


def phase_hybrid(card):
    """HybridEmbed over a ResNet-50 trunk, then 12 ViT-B blocks in bf16 on
    64 crops at 256x192: 48 tokens, 12 K1 launches a forward, held against
    the same modules with the plain attention."""
    from vitpose_tpu_torch.models.resnet import ResNet
    from vitpose_tpu_torch.models.vit import Block, HybridEmbed
    from vitpose_tpu_torch.ops.attention import fused_attention
    gen = torch.Generator().manual_seed(0)
    embed = HybridEmbed(ResNet(depth=50, dtype='bfloat16', generator=gen),
                        768, dtype='bfloat16', generator=gen)
    blocks = torch.nn.ModuleList(
        Block(768, 12, fused_attention=True) for _ in range(12))
    embed, blocks = embed.cuda().eval(), blocks.cuda().eval()
    x = torch.randn(TOOLS_BATCH, 256, 192, 3, generator=gen).cuda()

    def run():
        with torch.inference_mode():
            t = embed(x)
            for blk in blocks:
                t = blk(t, torch.bfloat16)
        return t

    reset_counts()
    out = run()
    torch.cuda.synchronize()
    k1 = fused_attention.launches
    check_shapes_held('tools hybrid')
    check(out.shape == (TOOLS_BATCH, 48, 768) and out.dtype == torch.bfloat16
          and bool(out.isfinite().all()), f'HybridEmbed + blocks gave '
          f'{tuple(out.shape)} {out.dtype}')
    check(k1 == 12, f'HybridEmbed + 12 blocks launched K1 {k1} times')
    ms = time_ms(run, calls=TOOLS_ITERS, rounds=1, warmup=1)
    for blk in blocks:
        blk.attn.fused = False
    plain = run()
    err = ((out.float() - plain.float()).norm() / plain.float().norm()).item()
    check(err <= TOOLS_HYBRID_TOL, f'HybridEmbed + blocks: K1 {err:.3g} '
          f'from the plain attention (limit {TOOLS_HYBRID_TOL})')
    return {'k1': k1, 'rel_err_vs_plain': err, 'ms': ms}


def phase_tools(card):
    """The item-14 tools and the item-15 functions on the card (see the
    TOOLS_* constants): every path's K1 and K2 launches counted and their
    shapes held; each tool's own check."""
    import shutil
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    from vitpose_tpu_torch.data import CocoIndex
    from vitpose_tpu_torch.models import infer
    from vitpose_tpu_torch.tools import test as test_cli
    from vitpose_tpu_torch.tools import test_new
    from vitpose_tpu_torch.tools.analysis import (benchmark_inference,
                                                  benchmark_processing,
                                                  get_flops,
                                                  int8_selective_sweep,
                                                  overfit_sanity,
                                                  profile_trace, speed_test)
    from vitpose_tpu_torch.tools.misc import (keypoints2coco_without_mmdet,
                                              publish_model)
    t_phase = time.perf_counter()
    launches, wall, res = {}, {}, {}
    root = tempfile.mkdtemp(prefix='tools')
    try:
        files, n_boxes = write_eval_set(root, 11, n_small=TOOLS_IMAGES,
                                        n_big=0)
        ckpt = peaks_checkpoint(root, COCO_B, 'vitpose_b_peaks')
        options = eval_options(root, files)
        prefix = root + '/'
        b, it = str(TOOLS_BATCH), str(TOOLS_ITERS)

        r, _, wall['get_flops'] = tool_run(
            'get_flops', launches, get_flops.main, [COCO_B])
        res['get_flops_gflops'] = r['flops'] / 1e9
        check(launches['get_flops'] == (12, 0), f'get_flops launched '
              f'{launches["get_flops"]}, expected 12 K1')

        r, _, wall['benchmark_inference'] = tool_run(
            'benchmark_inference', launches, benchmark_inference.main,
            [COCO_B, '--batch', b, '--iters', it])
        res['benchmark_inference_ms'] = r['ms']
        want = 24 * (1 + TOOLS_ITERS)
        check(launches['benchmark_inference'] == (want, 0),
              f'benchmark_inference launched '
              f'{launches["benchmark_inference"]}, expected {want} K1: 24 '
              'per flip-tested batch')
        r, _, wall['benchmark_inference_int8'] = tool_run(
            'benchmark_inference_int8', launches, benchmark_inference.main,
            [COCO_B, '--batch', b, '--iters', it, '--int8'])
        res['benchmark_inference_int8_ms'] = r['ms']
        want = 2 * 12 + 24 * (1 + TOOLS_ITERS)
        check(launches['benchmark_inference_int8'] == (want, 0),
              f'benchmark_inference --int8 launched '
              f'{launches["benchmark_inference_int8"]}, expected {want} K1: '
              '12 per calibration batch, 24 per flip-tested batch')

        r, _, wall['speed_test'] = tool_run(
            'speed_test', launches, speed_test.main,
            [COCO_B, '--bz', b, '--iters', it, '--warmup', '1'])
        res['speed_test_ms'] = r['ms']
        want = 12 * (1 + TOOLS_ITERS)
        check(launches['speed_test'] == (want, 0), f'speed_test launched '
              f'{launches["speed_test"]}, expected {want} K1: 12 a batch')

        for mode, names, per in (('infer', ('attn_fwd',), (24, 0)),
                                 ('train', ('attn_fwd', 'attn_bwd'),
                                  (12, 12))):
            out = os.path.join(root, f'trace_{mode}.json')
            r, _, wall[f'profile_{mode}'] = tool_run(
                f'profile_{mode}', launches, profile_trace.main,
                [COCO_B, '--out', out, '--mode', mode, '--batch', b,
                 '--steps', '2'])
            with open(out) as f:
                text = f.read()
            for name in names:
                check(name in text, f'the {mode} trace names no {name} '
                      'kernel')
            want = tuple(3 * n for n in per)
            check(launches[f'profile_{mode}'] == want, f'profile_trace '
                  f'--mode {mode} launched {launches[f"profile_{mode}"]} '
                  f'in 3 steps, expected {want}')
            res[f'profile_{mode}_trace_bytes'] = len(text)
            res[f'profile_{mode}_kernel_ms_per_step'] = sum(
                r['kernels_us'].values()) / 2 / 1e3

        n_batches = -(-n_boxes // EVAL_BATCH)
        r, _, wall['test'] = tool_run('test', launches, test_cli.main,
                                      [COCO_B, ckpt, '--cfg-options',
                                       *options])
        vis = os.path.join(root, 'vis')
        (stats, matches), _, wall['test_new'] = tool_run(
            'test_new', launches, test_new.main,
            [COCO_B, ckpt, '--save-dir', vis, '--num-images', '8',
             '--cfg-options', *options])
        for name in ('test', 'test_new'):
            check(launches[name] == (24 * n_batches, 0), f'{name} launched '
                  f'{launches[name]}, expected 24 K1 per batch')
        gap = max(abs(stats[k] - r[k]) for k in r)
        check(gap <= 1e-9, f'test_new AP {stats["AP"]} against tools/test.py '
              f'{r["AP"]}: stats {gap:.3g} apart')
        drawn = [f for f in os.listdir(vis) if f.endswith('.png')]
        check(test_new.HISTOGRAM in drawn and len(drawn) == 1 + len(
            test_new.sample_indices(len(matches), 8)), f'test_new wrote '
            f'{sorted(drawn)}')
        res['test_new_ap'] = stats['AP']
        res['test_new_matches'] = len(matches)

        out = os.path.join(root, 'pseudo.json')
        r, _, wall['keypoints2coco'] = tool_run(
            'keypoints2coco', launches, keypoints2coco_without_mmdet.main,
            [COCO_B, ckpt, '--json-file', files['ann'], '--img-root', prefix,
             '--out-json-file', out])
        pm = init_pose_model(COCO_B, ckpt, device='cuda')
        coco = CocoIndex(files['ann'])
        want_kpts = []
        for image_id in sorted(coco.imgs):
            people = [{'bbox': coco.anns[a]['bbox']}
                      for a in coco.getAnnIds(image_id)]
            poses, _ = inference_top_down_pose_model(
                pm, os.path.join(prefix, coco.imgs[image_id]['file_name']),
                people)
            for p in poses:
                k = np.asarray(p['keypoints'], np.float64).copy()
                low = k[:, 2] < 0.3
                k[low] = 0
                k[~low, 2] = 2
                want_kpts.append([int(v) for v in k.reshape(-1)])
        got = [a['keypoints'] for a in r['annotations']]
        check(got == want_kpts and len(got) == len(coco.anns),
              f'keypoints2coco: {len(got)} annotations, not the API\'s '
              f'{len(want_kpts)} keypoints')
        check(launches['keypoints2coco'] == (24 * TOOLS_IMAGES, 0),
              f'keypoints2coco launched {launches["keypoints2coco"]}, '
              'expected 24 K1 per image')

        pub, _, wall['publish_model'] = tool_run(
            'publish_model', launches, publish_model.main,
            [ckpt, os.path.join(root, 'vitpose_b.pth')])
        crops = torch.randn(8, 256, 192, 3,
                            generator=torch.Generator().manual_seed(5)).cuda()
        with torch.inference_mode():
            before = infer(pm.model, crops)
            pm_pub = init_pose_model(COCO_B, pub, device='cuda')
            after = infer(pm_pub.model, crops)
        check(torch.equal(before, after), 'the published .pth gives other '
              'heatmaps than the unpublished weights')
        del pm, pm_pub
        res['published'] = os.path.basename(pub)

        sweep, _, wall['int8_sweep'] = tool_run(
            'int8_sweep', launches, int8_selective_sweep.sweep,
            files['ann'], prefix, TOOLS_SWEEP_GRID)
        check(len(sweep['rows']) == len(TOOLS_SWEEP_GRID)
              and 0 < sweep['exact']['AP'] <= 1, f'int8 sweep gave {sweep}')
        k1, k2 = launches['int8_sweep']
        check(k1 > 0 and k2 == 0, f'int8 sweep launched {k1, k2}')
        res['int8_sweep'] = {'exact_ap': sweep['exact']['AP'],
                             'rows': sweep['rows']}

        work = os.path.join(root, 'overfit')
        evals, _, wall['overfit_sanity'] = tool_run(
            'overfit_sanity', launches, overfit_sanity.main,
            ['--ann', files['ann'], '--img-root', prefix, '--epochs', '2',
             '--work-dir', work])
        # 2 steps of 4 blocks (K1 and K2), 2 val batches of 12 flip-tested
        check(launches['overfit_sanity'] == (2 * 4 + 2 * 8, 2 * 4),
              f'overfit_sanity launched {launches["overfit_sanity"]}, '
              'expected (24, 8)')
        check(len(evals) == 1 and 0 <= evals[0]['AP'] <= 1,
              f'overfit_sanity evaluated {evals}')
        res['overfit_ap_epoch2'] = evals[0]['AP']

        r, _, wall['benchmark_processing'] = tool_run(
            'benchmark_processing', launches, benchmark_processing.main,
            ['--ann', files['ann'], '--prefix', prefix, '--batch', '8',
             '--iters', '1', '--num-workers', '2'])
        res['processing_img_s'] = {'host': r['host_img_s'],
                                   'device': r['device_img_s']}
        check(launches['benchmark_processing'] == (0, 0),
              'benchmark_processing launched a kernel')
    finally:
        shutil.rmtree(root, ignore_errors=True)
    hybrid = phase_hybrid(card)
    launches['hybrid_embed'] = (hybrid['k1'], 0)
    res['hybrid'] = hybrid
    total = time.perf_counter() - t_phase
    print('tools: on the card at full ViT-B width (COCO-B, bf16, K1; the '
          'int8 sweep f32 with K1, overfit_sanity ViT-S f32 with K1 and '
          'K2), K1, K2 launches per tool path: ' + ', '.join(
              f'{n} {a}/{b2}' for n, (a, b2) in launches.items())
          + '; wall s of main (model builds included): ' + ', '.join(
              f'{n} {v:.1f}' for n, v in wall.items())
          + f'; benchmark_inference batch {TOOLS_BATCH} flip '
          f'{res["benchmark_inference_ms"]:.2f} ms, --int8 '
          f'{res["benchmark_inference_int8_ms"]:.2f} ms, speed_test '
          f'{res["speed_test_ms"]:.2f} ms, HybridEmbed + 12 blocks '
          f'{hybrid["ms"]:.2f} ms ({hybrid["rel_err_vs_plain"]:.2g} from '
          f'the plain attention); test_new AP {res["test_new_ap"]:.4f} = '
          f'tools/test.py\'s; phase {total:.1f} s on {card}', flush=True)
    return {'launches': {n: {'k1': a, 'k2': b2}
                         for n, (a, b2) in launches.items()},
            'wall_s': wall, 'results': res, 'phase_s': total}


# bench: the seven bench_* analysis tools (tools/analysis/bench_*.py of the
# JAX package), each through its main(argv) on the card at full width and
# the tools' own batches; repetitions cut where the tools take knobs
BENCH_ZOO_ITERS = 2                   # timed calls per zoo model (JAX: 3)
BENCH_IO_ARGS = ['--n', '64', '--iters', '1']
BENCH_TRAIN_ITERS = 2                 # timed calls of 4 steps (JAX: 3)
BENCH_E2E_IMGS = 192                  # JPEGs of the fed loop (JAX: 768)
BENCH_E2E_STEPS = 6                   # timed fed steps (JAX: 40)
# the rates of the tools' JSON lines, each finite and positive
BENCH_RATE_KEYS = ('per_sec', 'ms_per_iter', 'imgs_per_sec', 'ms_per_step',
                   'e2e_imgs_per_sec', 'loader_imgs_per_sec',
                   'step_imgs_per_sec')


@contextlib.contextmanager
def bench_env(**env):
    """The BENCH_* knobs of bench_train set for a block, restored after."""
    before = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bench_json(name, text, want):
    """The JSON lines of a tool's output: `want` of them, each parsed,
    every rate in it finite and positive."""
    recs = [json.loads(line) for line in text.splitlines()
            if line.startswith('{')]
    check(len(recs) == want, f'bench {name} printed {len(recs)} JSON lines, '
          f'expected {want}')
    for rec in recs:
        for key in BENCH_RATE_KEYS:
            if key in rec:
                check(np.isfinite(rec[key]) and rec[key] > 0,
                      f'bench {name}: {key} {rec[key]} in {rec}')
    return recs


def check_bench_fused_layout():
    """K1 on bench_attn_pack's fused arm's layout: [B, S, H, D] views of
    [B, H, S, D] tensors at the serving shape, against the plain version at
    the kernel phase's tolerance (the kernel phase holds other strides)."""
    from vitpose_tpu_torch.ops import attention as attn
    from vitpose_tpu_torch.tools.analysis.bench_attn_pack import fused_core
    gen = torch.Generator(device='cuda').manual_seed(5)
    q, k, v = (torch.randn((256, 12, 192, 64), generator=gen, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    with torch.inference_mode():
        out = fused_core(q, k, v).transpose(1, 2).float()
        ref = attn.reference_attention(
            *(x.transpose(1, 2) for x in (q, k, v))).float()
    atol, rtol = TOLS[torch.bfloat16]
    bad = ((out - ref).abs() > atol + rtol * ref.abs()).sum().item()
    err = (out - ref).abs().max().item()
    check(bad == 0, f'K1 on [B, S, H, D] views of [B, H, S, D] disagrees '
          f'with plain: {bad} elements, max abs err {err}')
    return err


def phase_bench(card):
    """The seven bench tools on the card (see the BENCH_* constants): each
    tool's K1 and K2 launches counted and held to what its code implies,
    their shapes held (check_shapes_held); every JSON line parsed, every
    rate finite and positive."""
    from vitpose_tpu_torch.tools.analysis import (bench_attn_pack,
                                                  bench_batch_sweep,
                                                  bench_breakdown,
                                                  bench_fused_attention,
                                                  bench_io, bench_train,
                                                  bench_zoo)
    from vitpose_tpu_torch.models.vit import VIT_VARIANTS
    t_phase = time.perf_counter()
    launches, wall, res = {}, {}, {}
    depth = {v: VIT_VARIANTS[v]['depth'] for v in VIT_VARIANTS}

    def expect(name, want):
        check(launches[name] == want, f'bench {name} launched K1, K2 '
              f'{launches[name]}, expected {want}')

    res['fused_layout_err'] = check_bench_fused_layout()

    r, text, wall['zoo'] = tool_run('zoo', launches, bench_zoo.main,
                                    ['--iters', str(BENCH_ZOO_ITERS)])
    bench_json('zoo', text, len(bench_zoo.ZOO))
    check('| model | batch | imgs/s/card | GFLOP/img (FlopCounterMode) '
          '| TFLOP/s |' in text, 'bench zoo printed no table')
    want = 0
    for name, (path, batch, group) in bench_zoo.ZOO.items():
        variant = name.split('_')[1] if name.startswith('vitpose') else None
        # a warm-up and the timed calls of GROUP batches, and the FLOP
        # count's one batch: a launch a block each
        per = (depth[variant] * ((1 + BENCH_ZOO_ITERS) * group + 1)
               if variant else 0)
        check(r['launches'][name] == {'k1': per, 'k2': 0}, f'bench zoo '
              f'{name} launched {r["launches"][name]}, expected {per} K1')
        want += per
    expect('zoo', (want, 0))
    res['zoo'] = {row['model']: row for row in r['rows']}
    res['zoo_build_s'] = r['build_s']

    r, text, wall['fused_attention'] = tool_run(
        'fused_attention', launches, bench_fused_attention.main, [])
    # the plain arm none; the K1 arm 24 a flip-tested batch, 1 + 6 calls
    expect('fused_attention', (7 * 24, 0))
    check(r['plain']['launches']['k1'] == 0, 'the plain arm launched K1')
    res['fused_attention'] = {k: {'ms': v['ms'], 'img_s': v['img_s'],
                                  'first_s': v['first_s']}
                              for k, v in r.items()}

    r, text, wall['batch_sweep'] = tool_run(
        'batch_sweep', launches, bench_batch_sweep.main, [])
    expect('batch_sweep', (len(r) * 6 * 24, 0))
    res['batch_sweep'] = {b: {'ms': v['ms'], 'img_s': v['img_s']}
                          for b, v in r.items()}

    r, text, wall['attn_pack'] = tool_run(
        'attn_pack', launches, bench_attn_pack.main, [])
    # the fused arm: 12 chained launches in each of 1 + 5 calls
    expect('attn_pack', (12 * 6, 0))
    check(all(v['launches']['k1'] == (72 if n == 'fused' else 0)
              for n, v in r.items()), f'bench attn_pack launches '
          f'{ {n: v["launches"] for n, v in r.items()} }')
    res['attn_pack'] = {n: {'ms': v['ms'], 'tflops': v['tflops']}
                        for n, v in r.items()}

    r, text, wall['breakdown'] = tool_run(
        'breakdown', launches, bench_breakdown.main, [])
    recs = bench_json('breakdown', text, 8)
    # (1 + 3) calls of 4 batches, 12 blocks, on the three K1 arms; 4 calls
    # of one batch on group1
    expect('breakdown', (3 * 4 * 4 * 12 + 4 * 12, 0))
    res['breakdown'] = {rec['exp']: rec['per_sec'] for rec in recs}

    r, text, wall['io'] = tool_run('io', launches, bench_io.main,
                                   BENCH_IO_ARGS)
    expect('io', (0, 0))
    check(all(v > 0 for v in r['loader_img_s'].values()) and r['cv2_img_s']
          > 0, f'bench io rates {r}')
    res['io'] = r

    res['train'] = {}
    for variant in ('b', 'h'):
        with bench_env(BENCH_VARIANT=variant,
                       BENCH_TRAIN_ITERS=BENCH_TRAIN_ITERS, BENCH_E2E=0):
            r, text, wall[f'train_{variant}'] = tool_run(
                f'train_{variant}', launches, bench_train.main, [])
        bench_json(f'train_{variant}', text, 1)
        # remat 'full': per block and step 2 K1 (forward and recompute)
        # and 1 K2; a warm-up call and the timed calls of 4 steps
        steps = 4 * (1 + BENCH_TRAIN_ITERS)
        expect(f'train_{variant}', (2 * depth[variant] * steps,
                                    depth[variant] * steps))
        res['train'][variant] = {k: r[k] for k in ('imgs_per_sec',
                                                   'ms_per_step', 'peak_gib')}
    for mode in ('canvas', 'crop'):
        with bench_env(BENCH_E2E=1, BENCH_E2E_MODE=mode, BENCH_VARIANT='b',
                       BENCH_E2E_IMGS=BENCH_E2E_IMGS,
                       BENCH_E2E_STEPS=BENCH_E2E_STEPS):
            r, text, wall[f'e2e_{mode}'] = tool_run(
                f'e2e_{mode}', launches, bench_train.main, [])
        bench_json(f'e2e_{mode}', text, 1)
        # the first step, the timed ones, the step-only warm-up and its 20
        steps = 1 + BENCH_E2E_STEPS + 1 + bench_train.STEP_ONLY_STEPS
        expect(f'e2e_{mode}', (24 * steps, 12 * steps))
        check(np.isfinite(r['first_loss']), f'e2e {mode}: first loss '
              f'{r["first_loss"]}')
        res[f'e2e_{mode}'] = {k: r[k] for k in (
            'e2e_imgs_per_sec', 'loader_imgs_per_sec', 'step_imgs_per_sec',
            'fed', 'host_processes_needed', 'first_loss')}
    total = time.perf_counter() - t_phase
    zoo = res['zoo']
    print('bench: the bench_* tools on the card, K1, K2 launches per tool: '
          + ', '.join(f'{n} {a}/{b2}' for n, (a, b2) in launches.items())
          + '; wall s of main: ' + ', '.join(
              f'{n} {v:.1f}' for n, v in wall.items())
          + '; zoo model builds s: ' + ', '.join(
              f'{n} {v:.1f}' for n, v in res['zoo_build_s'].items())
          + '; zoo img/s: ' + ', '.join(
              f'{n} {v["imgs_per_sec"]}' for n, v in zoo.items())
          + f'; matmul_ceiling {res["breakdown"]["matmul_ceiling"]} TFLOP/s'
          + '; train ms/step ' + ', '.join(
              f'{v} {r2["ms_per_step"]} (peak {r2["peak_gib"]:.1f} GiB)'
              for v, r2 in res['train'].items())
          + '; e2e fed ' + ', '.join(
              f'{m} {res[f"e2e_{m}"]["fed"]}' for m in ('canvas', 'crop'))
          + f'; phase {total:.1f} s on {card}', flush=True)
    return {'launches': {n: {'k1': a, 'k2': b2}
                         for n, (a, b2) in launches.items()},
            'wall_s': wall, 'results': res, 'phase_s': total}


def kernel_name(mangled):
    """attn_fwd_pair<64,3> for the mangled name of a kernel template in an
    anonymous namespace; the mangled name where it is not one."""
    m = re.match(r'_ZN(\d+)_GLOBAL__N_', mangled)
    if not m:
        return mangled
    rest = mangled[m.start(1) + len(m.group(1)) + int(m.group(1)):]
    m = re.match(r'(\d+)', rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    args = re.match(r'I((?:Li\d+E)+)E', rest[m.end() + len(name):])
    if args:
        name += '<' + ','.join(re.findall(r'Li(\d+)E', args.group(1))) + '>'
    return name


def ptxas_report(logs):
    """One line per kernel from ptxas -v: registers, static shared memory
    and spill bytes (the whole-pair kernels take dynamic shared memory, the
    size `_plan` gives). Fails if any kernel spills."""
    spilled = []
    for src, log in logs.items():
        func, spill = None, (0, 0)
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                func = kernel_name(m.group(1))
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r'Used (\d+) registers', line)
            if m:
                smem = re.search(r'(\d+) bytes smem', line)
                print(f'build {src}: {func}: {m.group(1)} registers, '
                      f'{smem.group(1) if smem else 0} bytes static smem, '
                      f'spill stores/loads {spill[0]}/{spill[1]} bytes')
                if spill != (0, 0):
                    spilled.append(func)
        if not log:
            print(f'build {src}: built before this run, no ptxas report')
    check(not spilled, f'kernels that spill registers: {spilled}')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    try:
        from vitpose_tpu_torch.kernels import _build
    except ImportError as e:
        print(f'chip_smoke: run from the repo root ({e})', file=sys.stderr)
        return 1
    hrformer_f64 = pw_f64 = fam_refs = None
    try:
        card = card_line()
        print(f'env: {card}; torch {torch.__version__}, CUDA '
              f'{torch.version.cuda}, python {sys.version.split()[0]}',
              flush=True)

        laps = [('start', time.perf_counter())]

        def lap(name):
            laps.append((name, time.perf_counter()))

        t0 = time.perf_counter()
        logs = _build.build_all()
        build_s = time.perf_counter() - t0
        ptxas_report(logs)
        print(f'build: {", ".join(logs)} built by nvcc (sm_90a) in '
              f'{build_s:.1f} s', flush=True)

        lap('build')
        k1 = phase_kernel()
        lap('kernel')
        model, serve_launches, batch_s, img_s = phase_serve()
        print(f'serve: 256-crop batch (warp, bf16 ViT-B + K1, flip test, UDP '
              f'decode) median {batch_s * 1e3:.1f} ms = {img_s:.1f} img/s on '
              f'{card}', flush=True)
        lap('serve')
        ops = phase_ops(model, card)
        lap('ops')
        del model
        torch.cuda.empty_cache()
        phase_serve_ref()
        lap('serve-ref')
        int8 = phase_int8(card)
        lap('int8')
        serve_int8, int8_batch_ms = phase_serve_int8(card)
        lap('serve-int8')
        with tempfile.TemporaryDirectory() as root:
            deploy = phase_deploy(card, root)
        lap('deploy')
        with tempfile.TemporaryDirectory() as root:
            ckpt = peaks_checkpoint(root, COCO_B, 'vitpose_b_peaks')
            export_k1, export_rows = phase_export(card, root, ckpt)
            lap('export')
            demo_k1, demo_fps = phase_demos(card, root, ckpt)
            lap('demos')
            webcam = phase_webcam(card, root, ckpt)
            lap('webcam')
        torch.cuda.empty_cache()
        eval_launches, eval_int8 = phase_eval(card)
        lap('eval')
        k2 = phase_kernel_bwd()
        lap('kernel-bwd')
        train_launches, step_s, train_img_s, busy_ms = phase_train()
        print(f'train: step (preprocess on the card, forward, backward, '
              f'clip, AdamW) median {step_s * 1e3:.1f} ms over '
              f'{TIMED_STEPS} steps = {train_img_s:.1f} img/s on {card}',
              flush=True)
        torch.cuda.empty_cache()
        lap('train')
        phase_train_ref()
        lap('train-ref')
        torch.cuda.empty_cache()
        loop_launches, loop_steps, loop_val = phase_train_loop(card, busy_ms)
        lap('train-loop')
        remat_k1 = phase_remat(card)
        lap('remat')
        torch.cuda.empty_cache()
        moe_launches, moe_steps, moe_val = phase_moe_train(card)
        lap('moe-train')
        torch.cuda.empty_cache()
        phase_moe_ref(card)
        lap('moe-ref')
        torch.cuda.empty_cache()
        # HRFormer-B's float64 train-ref run goes on in its own process
        # through the CNN and bottom-up groups
        hrformer_f64 = F64Run(f64_run_child, (TD_CONFIGS['hrformer_base'],
                                              HRFORMER_REF_CROP))
        # and the family train-refs' float64 runs in one more, through the
        # same groups
        fam_refs = FamRefs(child=True)
        lap('fam-refs')
        cnn = run_cnn_phases(card)
        lap('cnn')
        cnn_more = run_cnn_more_phases(card)
        lap('cnn-more')
        cnn_ms = run_cnn_ms_phases(card)
        lap('cnn-ms')
        bu = run_bu_phases(card)
        lap('bu')
        bu_ms = run_phases('bu-ms', (('bu_ms', phase_bu_ms),), card)
        lap('bu-ms')
        # PoseWarper's float64 train-ref run goes on in its own process
        # through the td-rest group
        pw_f64 = start_pw_f64()
        td_rest = run_td_rest_phases(card, hrformer_f64)
        lap('td-rest')
        vid3d = run_vid3d_phases(card, pw_f64)
        lap('vid3d')
        fam = run_fam_phases(card, fam_refs)
        lap('fam')
        dist = phase_dist(card)
        lap('dist')
        torch.cuda.empty_cache()
        tools = phase_tools(card)
        lap('tools')
        torch.cuda.empty_cache()
        bench = phase_bench(card)
        lap('bench')
        print('phases: wall s ' + ', '.join(
            f'{name} {t - laps[i][1]:.1f}'
            for i, (name, t) in enumerate(laps[1:]))
            + f'; total {laps[-1][1] - laps[0][1]:.1f}', flush=True)
    except Failure as e:
        print(f'chip_smoke: FAIL {e}', file=sys.stderr)
        return 1
    finally:
        for run in (hrformer_f64, pw_f64, fam_refs):
            if run is not None:
                run.stop()

    kernels = []
    loop_k1, loop_k2 = loop_launches
    per_path = {'attention_fwd': {'serve': serve_launches,
                                  'export': export_k1,
                                  'demos_per_frame': demo_k1,
                                  'webcam': {m: {k: r[k] for k in
                                                 ('shown', 'inferred',
                                                  'k1')}
                                             for m, r in webcam.items()},
                                  'serve_int8': {f'skip_{k}': v['k1']
                                                 for k, v in
                                                 serve_int8.items()},
                                  'deploy_per_request': {
                                      m: r['k1_per_request']
                                      for m, r in deploy.items()},
                                  'eval': eval_launches,
                                  'eval_int8': eval_int8['k1'],
                                  'train': train_launches[0],
                                  'train_loop': loop_k1,
                                  'train_loop_steps': loop_steps,
                                  'train_loop_val_batches': loop_val,
                                  'remat_step': remat_k1,
                                  'moe_train': moe_launches[0],
                                  'moe_train_steps': moe_steps,
                                  'moe_train_val_batches': moe_val,
                                  **cnn_launches(cnn, 'k1'),
                                  **cnn_launches(cnn_more, 'k1',
                                                 'cnn_more'),
                                  **cnn_launches(cnn_ms, 'k1', 'cnn_ms'),
                                  **bu_launches(bu, 'k1'),
                                  **bu_ms_launches(bu_ms, 'k1'),
                                  **td_rest_launches(td_rest, 'k1'),
                                  **vid3d_launches(vid3d, 'k1'),
                                  **fam_launches(fam, 'k1'),
                                  'dist_world1_step': dist['world1']['k1'],
                                  'dist_two_ranks_step':
                                      dist['two_ranks']['k1'],
                                  'tools': {n: v['k1'] for n, v in
                                            tools['launches'].items()},
                                  'bench': {n: v['k1'] for n, v in
                                            bench['launches'].items()}},
                'attention_bwd': {'serve': 0, 'eval': 0, 'export': 0,
                                  'demos_per_frame': 0, 'webcam': 0,
                                  'train': train_launches[1],
                                  'train_loop': loop_k2,
                                  'train_loop_steps': loop_steps,
                                  'remat_step': dict.fromkeys(remat_k1, 12),
                                  'moe_train': moe_launches[1],
                                  'moe_train_steps': moe_steps,
                                  **cnn_launches(cnn, 'k2'),
                                  **cnn_launches(cnn_more, 'k2',
                                                 'cnn_more'),
                                  **cnn_launches(cnn_ms, 'k2', 'cnn_ms'),
                                  **bu_launches(bu, 'k2'),
                                  **bu_ms_launches(bu_ms, 'k2'),
                                  **td_rest_launches(td_rest, 'k2'),
                                  **vid3d_launches(vid3d, 'k2'),
                                  **fam_launches(fam, 'k2'),
                                  'dist_world1_step': dist['world1']['k2'],
                                  'dist_two_ranks_step':
                                      dist['two_ranks']['k2'],
                                  'tools': {n: v['k2'] for n, v in
                                            tools['launches'].items()},
                                  'bench': {n: v['k2'] for n, v in
                                            bench['launches'].items()}}}
    for name, line, rec, n in (('attention_fwd', 22, k1, train_launches[0]),
                               ('attention_bwd', 94, k2, train_launches[1])):
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'vitpose_tpu_torch/csrc/{name}.cu',
            'replaces': f'vitpose_tpu/ops/attention.py:{line}',
            'launches': n, 'max_abs_err': rec['err'], 'ms': rec['ms'],
            'plain_ms': rec['plain_ms'], 'bound_ms': rec['bound_ms'],
            'bound_by': rec['bound_by'], 'library_ms': rec['library_ms'],
            'design': rec['design'], 'old_design': 'tiled',
            'old_ms': rec['old_ms'],
            'device_ms': rec['device_ms'][rec['design']],
            'old_device_ms': rec['device_ms'].get('tiled'),
            'launches_per_path': per_path[name]})
    # the int8 product is a library call (torch._int_mm), as XLA's
    # dot_general is in JAX: not a kernel of the repo, listed beside them
    int8_matmul = {
        'name': 'int8_matmul', 'route': 'library (torch._int_mm)',
        'replaces': 'vitpose_tpu/models/vit.py:87',
        'launches_per_path': {
            'serve_int8': {f'skip_{k}': v['int_mm']
                           for k, v in serve_int8.items()},
            'deploy_per_request': {m: r['int_mm_per_request']
                                   for m, r in deploy.items()},
            'eval_int8': eval_int8['int_mm']},
        'shapes': int8,
        'serve_batch_ms': int8_batch_ms}
    print(json.dumps({'cnn': cnn}))
    print(json.dumps({'cnn_more': cnn_more}))
    print(json.dumps({'cnn_ms': cnn_ms}))
    print(json.dumps({'bottomup': bu}))
    print(json.dumps({'bottomup_ms': bu_ms}))
    print(json.dumps({'td_rest': td_rest}))
    print(json.dumps({'vid3d': vid3d}))
    print(json.dumps({'fam': fam}))
    print(json.dumps({'dist': dist}))
    print(json.dumps({'tools': tools}))
    print(json.dumps({'bench': bench}, default=str))
    print(json.dumps({'kernels': kernels, 'int8_matmul': int8_matmul,
                      'deploy_latency_ms': {
                          m: r['latency_ms'] for m, r in deploy.items()},
                      'eval_int8_ap': eval_int8['ap'],
                      'eval_bf16_ap': eval_int8['bf16_ap'],
                      'ops': ops,
                      'export': export_rows,
                      'demo_frames_per_s': demo_fps,
                      'webcam_frames_per_s': {m: r['fps'] for m, r in
                                              webcam.items()}}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
