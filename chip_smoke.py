"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--paths softmax,diffusion,ssn,prob_unet,ensemble,ensemble_folded,unet256,hrnet,multiclass,infer,eval,lidc_import,multidevice,retina,study,train,train_diffusion,train_ssn,train_prob_unet,train_hrnet,train_subensemble,train_multiclass,train_swag,train_ensemble]

With no argument every path runs; ``--paths`` picks a comma-separated group
of them (each needs its file under ``assets/``: a missing one is an error;
``train`` reads only ``ensemble16_quality.json``, ``train_subensemble``,
``eval``, ``lidc_import`` and ``multidevice`` only ``bench_unet16_toy128.npz``, the other
``train_*`` paths, ``study``, ``retina`` and ``unet256`` read none). Each training phase (and the study's) first runs
its timed in-process part (kernel checks, the counted and timed steps), one
after another with nothing else on the card; then the training paths' and
the study's runs through their entry points start
(``tools/train_recipe.py::Runs``, four at once), and each phase's untimed
rest (its run's losses, its checkpoint served, the study's report) waits
for its own run.
The kernel build, the kernels' checks at the softmax path's shapes and at
every other head width, and the checks at every shape of the chosen paths
always run.

Drives ``diffuncertainty_tpu_torch`` (never JAX, never ``diffuncertainty_tpu``):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` with plain ``nvcc``, one process per source,
   all started together (seconds printed);
   and what ``-Xptxas -v`` reports for each kernel instantiation
   (registers, spills);
3. each kernel against its plain PyTorch twin on the card, at the shapes the
   main paths give it: the fused-qkv attention kernel in bf16 at unet16's two
   attention shapes, and at every other head width the repo's networks use
   (one 256-row attention site of a network that has it, at 128x128) and at
   ragged token counts (8 rows, and 2 rows past 2048 tokens at d=16 and
   d=192); the GroupNorm+activation kernel at every
   norm shape of one unet16 forward in bf16 and fp32, at 256 rows and at the
   batch-1 path's 16 rows, with each launch's cluster plan (K, mode, shared
   memory, how many such clusters the card runs at once), at every other
   norm shape of one SSN and one prob-U-Net forward at their 16 rows (the
   prob-U-Net's widths 160 and 288 among them), and at unet256's
   1280- and 1536-channel norm shapes (2 rows, not timed); the attention
   kernel also at the 16-row sites of the SSN and prob-U-Net paths
   (d = 32, 64, 24, 48); kernel, twin and
   library-call times (CUDA events, median of 20 after a warm-up) beside the
   bound, and for GroupNorm also the kernel's device time (torch.profiler,
   the last 20 of 40 launches);
4. the softmax path: unet16 with the trained toy-128 weights, 16 MC-dropout
   members x TTA folded into one 256-row bf16 forward on 16 images at
   128x128, with the kernels' launch counts read around that one call;
5. the diffusion path: unet16 with the trained toy-128 diffusion weights,
   16 DDIM-10 trajectories on 16 images at 128x128 (ten 256-row bf16
   forwards per call), with the launch counts read around one call, and bf16
   held against fp32 from the same start noise;
6. the SSN path: unet16 with the trained toy-128 SSN weights, one 16-row
   bf16 forward on 16 images and 16 draws from its low-rank normal, with the
   launch counts read around one call, the count of elements whose
   covariance failed, and bf16 held against fp32 from the same draws;
7. the prob-U-Net path: the trained toy-128 prob-U-Net (base and prior
   encoder, one 16-row bf16 forward each, then 16 latent draws decoded by
   the fcomb), checked as the SSN path;
8. the ensemble path (``bench.py``'s "ensemble stack"): 16 unet16 members
   drawn on the card from the trained SWAG-diag moments (generator seed 42,
   scale 1.0), each one 16-row bf16 forward with MC-dropout live and its own
   TTA draw (``member_mode="params_stack"``, ``member_chunk=1``), with the
   launch counts read around one call, the mean EU over pixels, bf16 held
   against fp32 with the same members and draws, the median time of 10
   calls, and what binding a member's weights (``functional_call``) and
   casting them to bf16 cost (the sampler casts them once, when built);
8a. the folded ensemble (``ensemble_folded``): the same 16 members three
   ways: all in one member-folded 256-row forward (``member_chunk=None``,
   ``member_fold=True``: a ``DiffUnet(members=16)``, GroupNorm with its
   ``(16, C)`` affine), four folded 64-row forwards (``member_chunk=4``) and
   one member at a time (``member_chunk=1``); for each, every kernel shape
   it gives (from one uncounted call) checked against the twin first, then
   the counted call (11 / 56, 44 / 224, 176 / 896 launches, no twin), the
   stack and its EU, quality on the 256 test images inside the ensemble
   bands, the median ms per call of 10, img/s, device time and busy share
   (torch.profiler, 3 calls: the union of the kernel intervals, beside
   their plain sum) and peak memory; the "auto" choice beside the fastest;
   and an fp32 call with dropout 0 and TTA off whose folded logits and
   stack equal the one-member-at-a-time ones to atol 1e-5 and rtol 1e-4;
8b. unet256 (``unet256``): ``load_config(network="unet256")``, MC-dropout
   p 0.2, seeded random weights with every leaf non-zero (the flax init's
   zero output convs would hide both kernels from the logits), 16 members x
   TTA in one 256-row bf16 forward on 16 images: its new attention (d = 128,
   192) and GroupNorm (up to 1536 channels) shapes checked against the
   twins, 19 / 94 launches counted with no twin, the whole call against
   the same call with both twins forced (same draws; mean |dp| at most
   TOL's bf16 atol and argmax agreement 0.99), ms per call, img/s and peak
   memory;
9. the HRNet path (``bench.py``'s "hrnet x16"): hrnet-s with the trained
   toy-128 weights, 16 MC-dropout members (final dropout) x TTA folded into
   one 256-row bf16 forward on 16 images, BatchNorm on its running
   statistics; no attention or GroupNorm launch; the mean EU over pixels,
   bf16 held against fp32 with the same draws and the median time of 10
   calls;
10. the multiclass path (``bench.py``'s ``full_frame_multiclass``): unet16
   with the trained gta-toy label-switch weights (24 classes), 8 MC-dropout
   members one after another, each one 168-row bf16 forward of the 21
   windows (128, stride 64) of each of 8 frames of 256x512, tent-stitched;
   the kernels checked at its 168-row shapes first; the launch counts read
   around one call, frames/s from CUDA-event-timed calls after the first;
11. the inference job (``python -m diffuncertainty_tpu_torch.infer``, the
   user's entry point): a checkpoint of the port's format written to a temp
   directory (unet16 bf16 softmax with MC-dropout, the trained toy-128
   weights, the toy-128 data directory), the job run on it as a subprocess
   over the 256-image ``id`` split, 16 members x TTA, batch 16, seed 777
   (``bench.py``'s headline spec); the results tree checked (256 records in
   metrics.json and likelihood.json, 17 PNGs per image, TU = AU + EU and
   TU >= 0 in the TIFFs read back) and its mean Dice, mean BMA-GED and the
   AURC of 1 - Dice against -mean TU held to the softmax bf16 bands; then
   the same job built in process and one batch through its sampler and
   batch metrics with the launch counts read around it (11 attention, 56
   GroupNorm, no twin); the job's img/s, writes included, in the new process
   and in process once warm, with and without the writes, and the device
   time of one batch;
11a. the evaluation (the ``eval`` path, the job a ValUES user runs): the same
   checkpoint through ``python -m diffuncertainty_tpu_torch.infer ...
   --include_eval`` as a subprocess over the toy-128 ``val``, ``id``,
   ``ood_noise`` and ``ood_blur`` splits (16 + 256 + 16 + 16 images), one
   in-process batch of the job with the launches counted (11 / 56, no
   twin), then ``python -m diffuncertainty_tpu_torch.evaln.experiments
   --config`` (a JSON config: the version, the paired splits, ``val`` for
   the Platt fit, the dataset) with every task but the cleanups; every task
   file present, the ``id`` split's TU image-level AURC equal to
   ``metrics/aurc.py::aurc`` of 1 - Dice against -mean TU from the tree's
   own ``metrics.json`` and TIFFs (to 1e-9) and inside the softmax bf16
   band, every AUROC, detection rate and calibration error finite in
   [0, 1], every NCC in [-1, 1], the Platt parameters finite; the walls of
   the job and of the evaluation;
11b. the ValUES study (the ``study`` path, ``python -m
   diffuncertainty_tpu_torch.tools.values_study WORKDIR --quick``, the JAX
   study's quick matrix on the card): first one study net of every AU type
   of the full study (softmax, ssn, diffusion, prob_unet; unet4 cut by the
   study's SMALL_NET, fp32) for each EU method of the quick matrix, built
   by the port's trainer from the study's config, every GroupNorm shape of
   its training forward and of one inference batch of the cell's job (8,
   16, 24 and 32 channels at 32x32 and 16x16, the attention block's norm at
   256 tokens; train and inference rows) checked
   against the twin, the GroupNorm backward kernel at every site of the
   training forward checked as in 12, and that batch counted (GroupNorm launched once per
   site, no GroupNorm twin; attention at head width 4 on its fp32 twin by
   the gate); then the study as a subprocess beside the training runs: the
   report's artifacts and figures, a finite softmax-entropy baseline on
   ``ood_noise``, both AL directions computed, every version non-missing,
   the study's wall and each cell's train, infer and evaluate walls;
11c. the LIDC import (the ``lidc_import`` path), from synthetic CT scans to
   the evaluated job through the user's entry points: 16 seeded scans (one
   patient each, 96x96x48 voxels at 0.7x0.7x2.5 mm, intensities windowed to
   [0, 1], 1-2 nodules of 1-4 rater balls of 3-8 mm) through
   ``data/lidc_raw.py`` to the 128-px crops (63/127 mm voxels), their
   ``metadata.csv`` and the aggregated pickle; ``python -m
   diffuncertainty_tpu_torch.data.lidc_import`` as a subprocess (128 px, 4
   folds, test ratio 0.2, the OOD copies ``ood_noise``, ``ood_blur``,
   ``ood_contrast`` and ``ood_jpeg``; each shift's copies made again in
   process, timed and byte-equal); a reference-format Lightning ``.ckpt`` of
   the softmax asset (reference names under ``model.`` and
   ``ema_model.module.``, the port's mapping inverted; unet16 and lidc128
   ``hyper_parameters`` in the reference's layout, pickled as omegaconf
   containers) converted by ``python -m
   diffuncertainty_tpu_torch.tools.import_reference_checkpoint``, its raw
   and EMA weights equal to the asset bit for bit (a round trip through the
   port's own mapping: the reference names are held to the JAX package's in
   ``tests/test_torch_port_reference_import.py``); the job (``python -m
   diffuncertainty_tpu_torch.infer ... --include_eval``, bf16, 16 members x
   TTA, batch 16) over the id split and the four shifts: images per split as
   the splits say, TU = AU + EU to 1e-5 in every TIFF, each shift's
   image-level AUROC of TU and EU finite in [0, 1] (no quality band: the
   scans are synthetic); in process, the job's loader on the native reader
   (two reads a batch), one batch's kernel sites checked and its launches
   counted (11 / 56, no twin), and its heatmaps equal, bit for bit, to those
   of a sampler built from the asset with the same draws; every split's
   batch loading through the native reader and through the python path,
   alternated over three rounds (equal batches, ms a batch beside the
   sampler call's); the walls of each step. The raw readers need h5py (NPC) and pylidc with the LIDC-IDRI
   archive (LIDC), which this host lacks: the path starts from synthetic
   scans, and ``tests/test_torch_port_datasets.py``,
   ``test_torch_port_codecs.py``, ``test_torch_port_native_loader.py`` and
   ``test_torch_port_reference_import.py`` hold these modules to the JAX
   package's on the CPU;
11d. two ranks on the card (the ``multidevice`` path, the softmax asset):
   ``chip_smoke.py --multidevice-rank`` twice, with ``DU_COORDINATOR``,
   ``DU_NUM_PROCESSES=2``, ``DU_PROCESS_ID`` and ``DU_DIST_BACKEND=gloo``
   (CUDA tensors; NCCL refuses two ranks on one device), joined by
   ``parallel/distributed.py::initialize_distributed``; each rank runs the
   inference job at mesh (2, 1) (the MC-dropout asset, 16 members x TTA) and
   (1, 2) (a four-member deep ensemble of the asset with 2% seeded noise on
   every leaf, 4 TTA rounds, two members a rank in one folded block though
   ``member_chunk=1``) on the toy-128 16-image batch: its new kernel shapes
   against the twins, one call counted (11 / 56 a rank, no twin), three
   timed; four-member prob-U-Net and hrnet-s ensembles (the assets, 2%
   seeded noise) at (1, 2) and (2, 1); the trainer's validation at (2, 1)
   by the loader and with a tail batch that runs whole; then one bf16
   data-parallel step at (2, 1) from the asset's weights. The ranks run with
   this process's float32 settings (``exact_float32``: cuDNN's TF32, which
   torch starts on, off; the HRNet's heads run float32 convolutions). This
   process holds them to the single-process job and step on the same seeds:
   the gathered heatmaps and mean within the port's bf16 call tolerance
   (mean |d| at most TOL's bf16 atol, argmax agreement 0.99), the
   prob-U-Net and hrnet-s stacks at (1, 2) equal bit for bit (a rank runs
   its members as one process does), validation to 1e-2 relative, the
   step's loss to 1e-2 relative and each gradient leaf to STEP_GRAD_TOL
   (the zero-gradient leaves of the float64 step left out).
   A rank that fails or outlives MULTIDEVICE_TIMEOUT_S fails the path. Then
   a world of one on NCCL through ``initialize_distributed``;
11e. the retina pipelines (the ``retina`` path, no asset): the committed
   Pillow JPEGs (``tests/fixtures/retina_jpeg``: 512x512 4:2:0, 4:4:4 and
   gray) decoded on this host, without PIL, equal to Pillow's decode in
   every pixel; raw Chaksu (3 machines x 4 images at 512x512, 5 experts),
   RIGA (4 prime TIFFs x 6 pencil variants) and REFUGE (6 cases over
   train/val/test, 7 rater pairs, the JPEG fixtures) trees written by the
   port's writers, through ``python -m diffuncertainty_tpu_torch.data.retina``'s
   commands (``clean-riga``, ``chaksu``, ``chaksu-splits``, ``riga``,
   ``refuge``, ``retina-splits``) at image_size 128; the trees through
   ``MultiRaterDataset`` and ``BatchLoader`` with every rater (5, 6 and 7,
   the rater axis padded by zeros); two epochs of bf16 steps of ``python -m
   diffuncertainty_tpu_torch.train`` (unet16 softmax with MC-dropout, 3
   input channels, 3 classes); the job on its checkpoint (``python -m
   ...infer``, ``id_test``, 16 members x TTA, TU = AU + EU); one batch of
   it in process, its kernel sites checked, its launches counted (11 / 56);
12. the trainer (``python -m diffuncertainty_tpu_torch.train``, the user's
   entry point): each backward kernel (through its autograd Function: the
   kernel forward saving its statistics, the backward kernel) against fp32
   autograd of the twin on the same bf16 values and against the kernel's
   plain version on the card, both under GRAD_TOL, at the training shapes
   (attention at (16, 1024, 384) and (16, 256, 768), GroupNorm at unet16's
   norm sites at 16 rows with silu and with none); two calls bit-equal, the
   forward under grad bit-equal to the no-grad forward; the kernel's time
   beside the twin VJP's, the plain version's, the library backward's and
   the bound; one full-model bf16 step at batch 16 with the launches counted
   (11 and 56 forward and backward launches, no twin VJP, no forward twin),
   every leaf's gradient finite, nonzero and against the same step with both
   twins forced, and the step's split (forward, backward with the backward
   kernels' calls apart, optimizer and EMA), busy share and peak memory
   (torch.profiler over PROFILED_STEPS steps); then the first member of the JAX
   16-member recipe (seed 2024, eu none, 150 epochs, bf16, batch 16 on the
   toy-128 train split) trained from scratch as a subprocess, its loss
   falling, the EMA weights of its ``last`` checkpoint scored (one member,
   no TTA) inside the range of the 16 JAX members widened by half on the
   first 32 test images, where the members were scored, and on all 256
   reported, and the
   inference job run on that checkpoint as a subprocess, its mean Dice
   equal to the in-process one to 1e-4;
13. the trainer for the diffusion, SSN and prob-U-Net families (the
   ``train_diffusion``, ``train_ssn`` and ``train_prob_unet`` paths, each
   the family's recipe of ``tools/train_recipe.py`` trained from scratch):
   each backward kernel checked as in 12 at every attention and GroupNorm
   site of the family's training forward (the prob-U-Net's base, prior and
   posterior encoders at d = 24 and 48, the SSN's two head norms, the
   diffusion input's 5 channels); one counted bf16 step at batch 16 from
   step 2 (11 / 56, 11 / 58 and 21 / 106 forward launches, as many backward
   launches, no twin VJP; the SSN also in its mean-only phase, 11 / 57; the
   prob-U-Net base's unused head takes no backward: 105), each leaf against
   the twins-forced step; a short run through the entry point as a subprocess
   (diffusion 4 epochs with two DDPM validations, SSN 12 epochs across its
   mean-only flip with ``cov_failed`` per epoch, prob-U-Net 6 epochs with
   beta rising), its loss falling; its checkpoint's EMA weights in the
   family's serving sampler (110 / 560, 11 / 58, 16 / 81 launches, no
   twin) and in the inference job as a subprocess over the 256 images;
13a. ``trainer.remat`` (the ``train`` path): the remat forward and backward
   counted (each kernel's forward twice, 22 / 112, its backward once), its
   gradients against the stored forward's on the same generator state (fp32
   to 1e-6 of the largest gradient, bf16 to STEP_GRAD_TOL), peak memory with
   and without;
13b. the HRNet's training (``train_hrnet``, hrnet-s, MC-dropout): one counted
   bf16 step (neither kernel, no twin), the bf16 and fp32 steps' every leaf
   against a float64 step with the same draws at the trained asset
   (``HRNET_FP32_TOL``, ``HRNET_BF16_COS``), the stem's running statistics after a
   step by flax's rule, a remat step leaving the statistics as they are
   without it, the step's split; a 4-epoch run and its checkpoint (EMA
   weights and the run's statistics) in the HRNet serving path;
13c. the sub-ensemble mask trainer (``train_subensemble``) over the frozen
   softmax asset: one counted step (10 members, 110 / 560 forward and
   backward launches, no twin), a short run (``SUBENSEMBLE``) with its loss falling, the hard
   masks' mean IoU below 1 and the expected fill within
   ``SUBENSEMBLE_FILL_BAND`` of the target, the members folded in the sampler (their new shapes against the
   twins, 11 / 56 launches, EU > 0);
13d. the multiclass recipe's trainer (``train_multiclass``, gta-toy, switched
   masks): the step's split and checks, a 6-epoch run, its checkpoint
   through the multiclass path (88 / 448) and ``tools/multiclass_quality.py``;
   the SWAG-diag recipe's (``train_swag``): the counted step, a 4-epoch run
   collecting 4 snapshots, 16 members from its moments folded in the
   ensemble path; the deep ensemble's (``train_ensemble``): its first two
   seeds for 3 epochs each, their raw weights stacked and folded with TTA;
14. toy-128 quality of the softmax bf16 and fp32 paths, of the diffusion
   bf16 path and of the SSN, prob-U-Net, ensemble and HRNet bf16 paths, and
   the multiclass quality (macro Dice, GED, NCC of TU and AU against the
   analytic switch map), held to bands around the JAX package's recorded
   numbers (PARITY.md section 3 and its multiclass block, BENCH_r03.json,
   BENCH_r05.json).

Every counted call also counts the kernels' plain twins and fails if one ran.

The fp32 paths run in true fp32: TF32 is off for cuDNN convolutions and for
matmuls. Any failure raises, so the exit code is non-zero and the last line
is not printed. The last line is the device JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections.abc import Generator
from pathlib import Path

T0 = time.perf_counter()
REPO = Path(__file__).resolve().parent
ASSET = REPO / "assets" / "bench_unet16_toy128.npz"
ASSET_DIFFUSION = REPO / "assets" / "bench_unet16_toy128_diffusion.npz"
ASSET_SSN = REPO / "assets" / "bench_unet16_toy128_ssn.npz"
ASSET_PROB_UNET = REPO / "assets" / "bench_unet16_toy128_prob_unet.npz"
ASSET_SWAG = REPO / "assets" / "bench_unet16_toy128_swag.npz"
ASSET_HRNET = REPO / "assets" / "bench_hrnet_s_toy128.npz"
ASSET_MULTICLASS = REPO / "assets" / "bench_unet16_gtatoy_multiclass.npz"
ENSEMBLE16_QUALITY = REPO / "assets" / "ensemble16_quality.json"
PATH_ASSETS = {"softmax": ASSET, "diffusion": ASSET_DIFFUSION, "ssn": ASSET_SSN,
               "prob_unet": ASSET_PROB_UNET, "ensemble": ASSET_SWAG,
               "ensemble_folded": ASSET_SWAG,
               # seeded random weights: reads no file of the repo's assets
               "unet256": None, "hrnet": ASSET_HRNET,
               "multiclass": ASSET_MULTICLASS, "infer": ASSET,
               # evaluates the job's tree of the softmax asset
               "eval": ASSET,
               # the softmax asset as a reference checkpoint, served on LIDC crops
               "lidc_import": ASSET,
               # two ranks on the card: the softmax asset's job and a data-parallel step
               # (and the prob-U-Net and hrnet-s assets' ensembles)
               "multidevice": ASSET,
               # the retina pipelines on synthetic raw trees and committed JPEGs,
               # then a net trained from scratch on them
               "retina": None,
               # the ValUES study trains its own nets on generated toy data
               "study": None,
               # trains from scratch on the generated toy-128 data: reads only
               # the JAX members' quality record its bands come from
               "train": ENSEMBLE16_QUALITY,
               # train from scratch and read no file of the repo's assets
               "train_diffusion": None, "train_ssn": None, "train_prob_unet": None,
               # trains from scratch; its gradients are checked at the trained asset
               "train_hrnet": ASSET_HRNET,
               # learns masks over the frozen softmax asset
               "train_subensemble": ASSET,
               "train_multiclass": None, "train_swag": None, "train_ensemble": None}
PATHS = tuple(PATH_ASSETS)

# kernel vs its twin: |kernel - twin| <= ATOL + RTOL*|twin| elementwise.
# bf16: one rounding step of the output is 2^-8 relative; the two differ only
# in the order of f32 sums, which can move the final rounding by one step.
# fp32 (GroupNorm only): the f32 statistics are summed in another order.
TOL = {"bfloat16": (4e-3, 2.0 ** -7), "float32": (1e-5, 1e-5)}
# Toy-128 quality bands around PARITY.md section 3 (about 10x the JAX
# package's own fast-vs-exact deltas, for torch's different random draws).
# The softmax numbers are on the 256-image test split (since round 4); the
# diffusion numbers were measured in rounds 2 and 3 (BENCH_r02/r03.json) on
# the 32-image split of that time, which is the first 32 images of today's
# split, and the diffusion family was not measured again: it is held on
# those 32 images and only reported on all 256. The SSN and prob-U-Net
# numbers (16 samples each) are on the 256-image split (since round 4), and
# so is the ensemble (16 SWAG-diag members x MC-dropout x TTA, BENCH_r05.json
# family_quality.ensemble_stack). HRNet was last measured in round 3
# (BENCH_r03.json ``hrnet.quality``) on the 32-image split: held there,
# reported on 256.
PARITY = {
    "bf16": {"dice": 0.9496, "ged_bma": 0.0383, "aurc": 0.04505, "ece": 0.01436},
    "fp32": {"dice": 0.9493, "ged_bma": 0.0377, "aurc": 0.04552, "ece": 0.0138},
    "diffusion_bf16_32": {"dice": 0.9583, "ged_bma": 0.0185, "aurc": 0.03304, "ece": 0.01458},
    "ssn_bf16": {"dice": 0.9462, "ged_bma": 0.0276, "aurc": 0.04918, "ece": 0.00958},
    "prob_unet_bf16": {"dice": 0.9486, "ged_bma": 0.0258, "aurc": 0.04531, "ece": 0.00341},
    "ensemble_bf16": {"dice": 0.9484, "ged_bma": 0.0397, "aurc": 0.04406, "ece": 0.00344},
    "hrnet_bf16_32": {"dice": 0.9498, "ged_bma": 0.0372, "aurc": 0.0483, "ece": 0.00778},
}
BANDS = {"dice": 0.005, "ged_bma": 0.005, "aurc": 0.01, "ece": 0.005}
# Multiclass quality (PARITY.md, multi-class block: fp32, the TPU's draws)
# and its bands: Dice and GED +-0.01, the NCCs +-0.02; the JAX package's own
# range over four dropout keys is narrower on every metric (PERF.md §6).
MULTICLASS_PARITY = {"dice_macro": 0.5084, "ged_multiclass": 0.313,
                     "ncc_tu_vs_analytic": 0.3406, "ncc_au_vs_analytic": 0.3389}
MULTICLASS_BANDS = {"dice_macro": 0.01, "ged_multiclass": 0.01,
                    "ncc_tu_vs_analytic": 0.02, "ncc_au_vs_analytic": 0.02}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 outside
# the tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BATCH, HW, MEMBERS = 16, 128, 16
TRAJECTORIES, DDIM_STEPS = 16, 10
SAMPLES = 16  # SSN logit draws and prob-U-Net latent draws per image
# (HW / side, C) of the attention sites of the 16-row SSN (unet16) and
# prob-U-Net (widths x0.75) forwards, T = side**2, 4 heads: d = 32, 64, 24, 48
ATTENTION_SITES16 = ((4, 128), (8, 256), (4, 96), (8, 192))
# per 16-row call: (attention launches, GroupNorm launches)
GENERATIVE16_LAUNCHES = {"ssn": (11, 58), "prob_unet": (16, 81)}
# the ensemble: 16 stacked members drawn from the SWAG-diag moments (seed 42)
SWAG_SEED = 42
# (T, C, network) of one attention site at 128x128 (4 heads) for every head
# width beside unet16's 32 and 64; timed at the main path's 256 rows
ATTENTION_WIDTH_SITES = ((1024, 64, "unet4"), (1024, 96, "prob-U-Net"),
                         (256, 192, "prob-U-Net"), (64, 384, "unet64"),
                         (256, 512, "unet256"), (64, 768, "unet256"))
# ragged token counts checked (not timed) at every head width, 8 rows
RAGGED_TOKENS = (1, 80, 1000)
# ragged token counts past the Pallas kernel's 2048, checked at the narrowest
# and widest head width, 2 rows
LONG_TOKENS = (2049, 4100)
# unet256's norms wider than 1024 channels at 128x128 (shape without batch),
# checked (not timed) at 2 rows
WIDE_NORM_SITES = ((8, 8, 1280), (8, 8, 1536), (16, 16, 1280))
# attention calls per unet16 forward by token count: 5 at HW/4, 6 at HW/8
UNET16_ATTENTION = {(HW // 4) ** 2: (5, 128), (HW // 8) ** 2: (6, 256)}
# the train path: the first member of the JAX 16-member recipe
# (tools/train_bench_assets.py::_load_cfg with seed 2024, eu none, 150 epochs,
# assets/ensemble16_quality.json), trained from scratch
TRAIN_SEED, TRAIN_EPOCHS = 2024, 150
# Each metric's range over the 16 JAX-trained members (single member, no
# TTA; ensemble16_quality.json member_quality), widened by half the range on
# each side: the JAX package's own spread over seeds. The members were
# scored on the 32-image test split of the record's time (the JAX
# tools/quality.py then generated num_test=32; 256 since the next commit,
# whose first 32 images are that split), so the bands hold there; the
# 256-image numbers are reported.
TRAIN_BANDS = {"dice": (0.9299, 0.9533), "ged_bma": (0.0511, 0.0983),
               "aurc": (0.0380, 0.0518), "ece": (0.0284, 0.0494)}
# A backward kernel against autograd of the twin in fp32 on the same bf16
# values (and against the kernel's plain version, which computes in f32):
# |g - g32| <= A * max|g32| + R * |g32|. The kernel rounds the gradient it
# returns (2^-9 relative) and, inside the attention, the probabilities and
# their gradient (2^-9 each) where they enter a bf16 product, before sums of
# up to 1024 terms whose cancellations leave an error of the sum's scale,
# not the element's: A = 2^-6 (eight such roundings), R = 2^-7.
GRAD_TOL = (2.0 ** -6, 2.0 ** -7)
# One full-model bf16 step through the kernels against the same step with
# both twins forced: the forwards differ by one bf16 rounding (2^-8
# relative) at some elements of each of the 67 sites, carried through the
# network and the backward; each leaf's relative L2 error of its gradient
# is held to 0.05 (about a dozen such roundings). A leaf whose exact
# gradient is 0 is left out (both hold rounding noise only): a bias that
# reaches the loss only through a GroupNorm of one channel per group, found
# by the same step in float64 (chip_smoke.null_gradient_leaves).
STEP_GRAD_TOL = 0.05
# The train_diffusion, train_ssn and train_prob_unet paths: each family's
# recipe (tools/train_recipe.py::recipe_tokens, bf16, batch 16, the toy-128
# train split) trained from scratch. Per family: the epochs of the short run
# through the entry point and its extra tokens, the launches (= VJPs) of
# one training step (attention, GroupNorm), the SSN's in its mean-only
# epochs, and the launches of one call of the family's serving sampler.
TRAIN_FAMILIES = {
    "diffusion": {"epochs": 4, "extra": ["trainer.val_every_n_epochs=2"], "step": (11, 56),
                  "serve": (DDIM_STEPS * 11, DDIM_STEPS * 56)},
    "ssn": {"epochs": 12, "extra": [], "step": (11, 58), "mean_only_step": (11, 57),
            "serve": GENERATIVE16_LAUNCHES["ssn"]},
    # base, prior and posterior encoders: the serving path's 16 / 81 and the
    # posterior's 5 / 25; the base's output head is computed and not used
    # (the fcomb decodes), so its norm's backward does not run: 105 GroupNorm
    # backward launches
    "prob_unet": {"epochs": 6, "extra": ["trainer.val_every_n_epochs=3"], "step": (21, 106),
                  "step_bwd": (21, 105), "serve": GENERATIVE16_LAUNCHES["prob_unet"]},
}
# The training paths of the HRNet, the multiclass recipe, SWAG-diag and the
# deep ensemble: the run of each through its entry point (tools/train_recipe.py's
# recipe cut to a few epochs; the ensemble's first two seeds), ENTRY_JOBS at
# once once every timed phase is done.
ENTRY_JOBS = 4
NEW_TRAIN_RUNS = {
    "train_hrnet": {"recipe": "hrnet", "epochs": 4, "extra": ["trainer.val_every_n_epochs=2"]},
    "train_multiclass": {"epochs": 6, "extra": []},
    "train_swag": {"recipe": "swag", "epochs": 4, "extra": []},
    "train_ensemble": {"recipe": "ensemble", "epochs": 3, "extra": [], "seeds": (2024, 2061)},
}
# The HRNet's bf16 and fp32 training steps against a float64 step with the same
# draws, at the trained hrnet-s asset (leaves whose float64 gradient is below
# 1e-6 of the largest left out: a bias before a train-mode BatchNorm has an
# exact gradient of 0). fp32: each leaf's relative L2 error to 0.02 (on the
# CPU, 16 test images through the same weights, fp32's is 0.0094 at most).
# bf16 rounds every conv and BatchNorm output (2^-8 relative) and the 126
# train-mode BatchNorms divide by statistics of those values: on the card its
# gradient sits at a cosine of 0.957 from float64's, each leaf up to 0.495
# off (median 0.114; three runs, 0.490-0.495). Held to a cosine of 0.8, each
# leaf to 0.75 (a leaf whose gradient is dropped reads 1.0, a flipped one
# 2.0) and each leaf's own cosine to 0.5 (dropped: 0; flipped: -1)
HRNET_FP32_TOL, HRNET_BF16_COS, HRNET_BF16_LEAF, HRNET_BF16_LEAF_COS = 0.02, 0.8, 0.75, 0.5
# The mask trainer's smoke run over the softmax asset: 10 masks, a constant
# temperature (so that the falling loss shows the masks learning, not the
# annealing), the target fill that zero logits give (0.5 x 0.5), and how far
# from it the expected fill the size penalty acts on may end (the hard masks'
# fill is printed). ``normalize`` off: with the keep-ratio rescale the soft
# masks' level no longer reaches the task loss (the rescale divides it out),
# so in a short run the diversity and size terms, whose small gradients Adam
# turns into full steps, drive whole layers' logits (the two-channel head's
# among them) below 0 and the hard members predict nothing (EU 0 on the card
# and the CPU). Without it the task holds the kept channels up (the head's
# logits +0.35, EU 0.046 on the CPU), and the diversity term at its default
# 1.0 pulls the expected fill to 0.18, under the target the size penalty only
# bounds from above: 0.1 leaves the task and the penalty to set it
SUBENSEMBLE = dict(num_masks=10, steps=8, learning_rate=0.05, temp_start=1.0, temp_end=1.0,
                   target_fraction=0.25, diversity_coeff=0.1, normalize=False, seed=0)
SUBENSEMBLE_FILL_BAND = 0.1
# the same run with the JAX defaults for the two, driven untimed and not held:
# tests/test_torch_port_subensemble_train.py runs it on a small net through both
# trainers (float64), which end with the same hard masks (fill 0.028 against
# the target 0.25: the diversity term drives the logits below 0 in JAX too)
SUBENSEMBLE_DEFAULTS = {**SUBENSEMBLE, "normalize": True, "diversity_coeff": 1.0}
# the folded ensemble: per strategy, the sampler's member fields and the
# launches of one call (attention, GroupNorm)
FOLD_STRATEGIES = {"folded": (dict(member_chunk=None, member_fold=True), (11, 56)),
                   "chunk4": (dict(member_chunk=4), (44, 224)),
                   "chunk1": (dict(member_chunk=1), (176, 896))}
# unet256: the weights' seed and the launches of one 256-row forward
UNET256_SEED, UNET256_LAUNCHES = 256, (19, 94)
# a whole bf16 call through the kernels against the same call through both
# twins, same draws: each of the 113 sites may move an element by one bf16
# rounding (TOL), which the network carries to the probabilities; their
# mean |dp| is held to TOL's bf16 atol and the argmax to 99% agreement
TWIN_CALL_TOL = (TOL["bfloat16"][0], 0.99)
# the multiclass path (bench.py:698-701): frames, frame size, window, stride,
# members, switched references per frame, seed
MC_FRAMES, MC_SIZE, MC_WINDOW, MC_STRIDE, MC_MEMBERS, MC_SEED = 8, (256, 512), 128, 64, 8, 1234
# The study path: the port's ValUES study (tools/values_study.py) at the JAX
# study's --quick matrix (softmax and ssn x none and dropout x seeds 0 and 1,
# 3 epochs, 16 train / 8 test images at 32 px, ood_noise, the AL arm), run
# through its command line on the card; before it, one study net of every AU
# type of the full study (unet4 cut by SMALL_NET, fp32: GroupNorm at 8, 16,
# 24 and 32 channels, the decoder's at the skip-concatenated widths;
# attention at 16x16 with 16 channels, head width 4)
STUDY_ARGV = ["--quick"]
STUDY_AU_TYPES = ("softmax", "ssn", "diffusion", "prob_unet")
STUDY_ARTIFACTS = {"REPORT.md", "summary.json", "ds_task_table.csv", "ds_task_table.tex",
                   "ds_task_ranks.csv", "au_eu_scatter.json"}
STUDY_FIGURES = {"risk_coverage", "reliability", "ood_auroc_ood_noise", "al_improvement",
                 "triptych", "task_overview"}
# the busy share and peak memory of a training step: torch.profiler over this
# many steps (its trace of every op costs seconds a step to take and read)
PROFILED_STEPS = 2


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def check_close(name: str, out, ref, dtype_name: str) -> float:
    import torch

    atol, rtol = TOL[dtype_name]
    err = (out.float() - ref.float()).abs()
    max_err = err.max().item()
    bad = (err > atol + rtol * ref.float().abs()).sum().item()
    if not torch.isfinite(out.float()).all() or bad:
        raise AssertionError(f"{name} disagrees with its twin: {bad} elements beyond "
                             f"{atol} + {rtol}*|ref|, max |d| {max_err:.3e}")
    return max_err


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    log(f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    exact_float32()
    return smi


def exact_float32() -> None:
    """float32 convolutions and matmuls without TF32, in this process and in
    every process it starts for the card (torch turns cuDNN's TF32 on by
    default; the HRNet's heads run float32 convolutions)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _kernel_name(demangled: str) -> str:
    """``void <unnamed>::kernel<(int)32>(args)`` -> ``kernel<32>``."""
    name = re.sub(r"\((?:int|bool)\)", "", demangled).replace("(anonymous namespace)", "")
    return re.sub(r"\(.*", "", name).split("::")[-1]


def ptxas_report(out: str) -> dict:
    """{kernel instantiation: registers and spills} from ``nvcc -Xptxas -v``."""
    names, entry, report = [], None, {}
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            names.append(entry)
        elif entry and ("registers" in line or "spill" in line):
            report.setdefault(entry, []).append(line.split(":", 1)[-1].strip()
                                                if "ptxas" in line else line.strip())
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and names:
        plain = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(plain) == len(names):
            short = {n: _kernel_name(p) for n, p in zip(names, plain)}
            report = {short[k]: v for k, v in report.items()}
    return {k: "; ".join(v) for k, v in report.items()}


def phase_build() -> dict:
    from diffuncertainty_tpu_torch.ops import _build

    seconds = _build.build_all()
    log(f"build: {_build.sources()} with {_build.find_nvcc()} in {seconds:.2f}s "
        f"(one nvcc per source, in parallel)")
    reports = {}
    for name, out in _build.build_log.items():
        if "error" in out.lower():
            log(f"  nvcc[{name}]: {out.strip()}")
        reports[name] = ptxas_report(out)
        for entry, text in reports[name].items():
            log(f"  ptxas[{name}] {entry}: {text}")
    return reports


def attention_case(b: int, t: int, c: int, heads: int, seed: int, timed: bool = True) -> dict:
    import torch
    import torch.nn.functional as F

    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import event_ms as median_ms

    gen = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    out = ca.qkv_attention_cuda(qkv, heads)
    ref = ca.qkv_attention_reference(qkv, heads)
    torch.cuda.synchronize()
    ch = c // heads
    max_err = check_close(f"qkv_attention kernel at B={b} T={t} C={c} d={ch}", out, ref,
                          "bfloat16")
    case = {"B": b, "T": t, "C": c, "heads": heads, "d": ch, "max_abs_err": max_err}
    if not timed:
        log(f"qkv_attention B={b} T={t} C={c} d={ch}: max|kernel-twin| {max_err:.3e}")
        return case
    ms = median_ms(lambda: ca.qkv_attention_cuda(qkv, heads))
    plain_ms = median_ms(lambda: ca.qkv_attention_reference(qkv, heads), runs=5, warmup=1)
    qh = qkv.view(b, t, heads, 3 * ch).permute(0, 2, 1, 3)
    q, k, v = (qh[..., i * ch:(i + 1) * ch].contiguous() for i in range(3))
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=ch ** -0.5))
    flops = 4.0 * b * heads * t * t * ch
    nbytes = 2.0 * (b * t * 3 * c + b * t * c)
    bound_flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes_ms = nbytes / PEAK_BYTES * 1e3
    case.update({
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bound_flops_ms, bound_bytes_ms),
        "bound_by": "operations" if bound_flops_ms >= bound_bytes_ms else "bytes",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    })
    log(f"qkv_attention B={b} T={t} C={c} d={ch}: max|kernel-twin| {max_err:.3e}, "
        f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
        f"(kernel/sdpa {ms / library_ms:.2f}), bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}: {case['gflop']:.1f} GFLOP, {case['mbytes']:.1f} MB; "
        f"kernel/bound {ms / case['bound_ms']:.2f})")
    del qkv, out, ref, q, k, v, qh
    torch.cuda.empty_cache()
    return case


def attention_width_cases() -> list[dict]:
    """Every other head width, timed at one network site, then every head
    width at ragged token counts, then long ragged inputs past 2048 tokens."""
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca

    rows = BATCH * MEMBERS
    cases = []
    for i, (t, c, network) in enumerate(ATTENTION_WIDTH_SITES):
        cases.append(dict(attention_case(rows, t, c, 4, seed=100 + i), network=network))
    for ch in ca.HEAD_DIMS:
        for t in RAGGED_TOKENS:
            cases.append(attention_case(8, t, 4 * ch, 4, seed=200 + ch + t, timed=False))
    for ch in (ca.HEAD_DIMS[0], ca.HEAD_DIMS[-1]):
        cases.append(attention_case(8, 2048, 4 * ch, 4, seed=300 + ch, timed=False))
        for t in LONG_TOKENS:
            cases.append(attention_case(2, t, 4 * ch, 4, seed=400 + ch + t, timed=False))
    widths = {c["d"] for c in cases}
    if widths != set(ca.HEAD_DIMS):
        raise AssertionError(f"head widths checked {sorted(widths)} != {ca.HEAD_DIMS}")
    return cases


def group_norm_case(shape: tuple, dtype_name: str, act: str, seed: int,
                    timed: bool = True, members: int = 0) -> dict:
    """The kernel against its twin at ``shape``; ``members`` > 0: an
    ``(members, C)`` affine over member-major rows (a folded ensemble's)."""
    import torch
    import torch.nn.functional as F

    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
    from diffuncertainty_tpu_torch.ops.norm import num_groups_for
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import device_ms
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import event_ms as median_ms

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator("cuda").manual_seed(seed)
    c = shape[-1]
    x = (3.0 * torch.randn(shape, generator=gen, device="cuda") + 1.0).to(dtype)
    lead = (members,) if members else ()
    scale = torch.randn(lead + (c,), generator=gen, device="cuda")
    bias = torch.randn(lead + (c,), generator=gen, device="cuda")
    out = gn.group_norm_act(x, scale, bias, act)
    ref = gn.group_norm_act_reference(x, scale, bias, act)
    torch.cuda.synchronize()
    max_err = check_close(f"group_norm_act kernel at {shape} {dtype_name} {act}", out, ref,
                          dtype_name)
    s = x.numel() // (shape[0] * c)
    plan = gn.cluster_plan(s, c, dtype, shape[0])
    clusters = gn.max_active_clusters(s, c, dtype, act, plan, x.device)
    case = {"shape": list(shape), "dtype": dtype_name, "act": act, "members": members,
            "max_abs_err": max_err,
            "cluster": plan.cluster, "mode": plan.mode, "smem": plan.smem,
            "threads": plan.threads, "cache_pix": plan.cache_pix,
            "slice_pix": plan.slice_pix, "active_clusters": clusters}
    plan_text = (f"K={plan.cluster} {plan.mode} ({plan.cache_pix}/{plan.slice_pix} px cached), "
                 f"{plan.threads} threads, {plan.smem} B shared, {clusters} clusters at once")
    if not timed:
        affine = f", ({members}, {c}) affine" if members else ""
        log(f"group_norm_act {shape} {dtype_name} {act}{affine}: max|kernel-twin| "
            f"{max_err:.3e}; {plan_text}")
        return case
    ms = median_ms(lambda: gn.group_norm_act(x, scale, bias, act))
    dev_ms = device_ms(lambda: gn.group_norm_act(x, scale, bias, act))
    plain_ms = median_ms(lambda: gn.group_norm_act_reference(x, scale, bias, act), runs=5,
                         warmup=1)
    # library: one F.group_norm (+ F.silu) on the channels-last NCHW view
    xv = x.movedim(-1, 1)
    sc, bi, groups = scale.to(dtype), bias.to(dtype), num_groups_for(c)

    def library():
        y = F.group_norm(xv, groups, sc, bi, 1e-5)
        return F.silu(y) if act == "silu" else y

    library_ms = median_ms(library)
    numel = x.numel()
    nbytes = 2.0 * numel * x.element_size() + 2 * c * 4
    # f32 operations per value: add, multiply, add (statistics), one fma
    # (normalize and affine), exp, add, divide (SiLU)
    flops = numel * (5.0 + (3.0 if act == "silu" else 0.0))
    bound_bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound_flops_ms = flops / PEAK_FP32_FLOPS * 1e3
    case.update({
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bound_bytes_ms, bound_flops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_flops_ms else "operations",
        "bound_bytes_ms": bound_bytes_ms, "bound_ops_ms": bound_flops_ms,
        "mbytes": nbytes / 1e6,
    })
    device = "not measured" if dev_ms is None else (
        f"{dev_ms:.4f} ms, {dev_ms / case['bound_ms']:.2f}x the bound")
    log(f"group_norm_act {shape} {dtype_name} {act}: max|kernel-twin| {max_err:.3e}; "
        f"{plan_text}; kernel {ms:.4f} ms (device {device}), twin {plain_ms:.4f} ms, "
        f"F.group_norm {library_ms:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}: {case['mbytes']:.1f} MB)")
    del x, xv, out, ref
    torch.cuda.empty_cache()
    return case


@functools.lru_cache(maxsize=1)
def ensemble_members():
    """The ensemble's 16 members, drawn once on the card from the SWAG-diag
    moments and shared by every ensemble sampler (bf16 and fp32)."""
    import torch

    from diffuncertainty_tpu_torch.core.params import load_swag_npz
    from diffuncertainty_tpu_torch.tools.bench_assets import swag_draw_members

    moments = load_swag_npz(ASSET_SWAG)
    return swag_draw_members(moments.mean, moments.std,
                             torch.Generator("cuda").manual_seed(SWAG_SEED), MEMBERS)


def build_path(precision: str, separable: bool, model: str = "softmax", **members_fields):
    """(config, built model, sampler) of a path; ``members_fields``
    (``member_chunk``, ``member_fold``) replace the ensemble's one member at
    a time."""
    import dataclasses

    import torch

    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.core.params import load_into
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.sampling.sampler import SamplerSpec, make_sampler
    from diffuncertainty_tpu_torch.sampling.tta import TTAConfig

    members = None  # the ensemble's stacked member weights
    if model in ("ssn", "prob_unet"):
        cfg = load_config(data="lidc128", network="unet16", model=model, eu_method="none",
                          precision=precision)
        built = build_model(cfg, device="cuda")
        load_into(built.module, ASSET_SSN if model == "ssn" else ASSET_PROB_UNET)
        spec = SamplerSpec(n_pred=SAMPLES, n_members=1, member_mode="single")
    elif model == "diffusion":
        cfg = load_config(data="lidc128", network="unet16", model="diffusion", eu_method="none",
                          precision=precision)
        built = build_model(cfg, device="cuda")
        load_into(built.module, ASSET_DIFFUSION)
        spec = SamplerSpec(n_pred=TRAJECTORIES, n_members=1, member_mode="single",
                           diffusion_sampler="ddim", diffusion_num_steps=DDIM_STEPS)
    else:  # softmax, the ensemble or HRNet: bench.py's build() with dropout live
        cfg = load_config(data="lidc128", network="hrnet-s" if model == "hrnet" else "unet16",
                          model="softmax", eu_method="dropout", precision=precision)
        built = build_model(cfg, device="cuda")
        if model == "ensemble":
            members = ensemble_members()
        else:
            load_into(built.module, ASSET_HRNET if model == "hrnet" else ASSET)
        tta = TTAConfig(hflip_p=0.5, rotation_limit=22.5, scale_limit=(-0.2, 0.2),
                        separable_warp=separable)
        spec = SamplerSpec(n_pred=1, n_members=MEMBERS, tta=True, tta_config=tta,
                           member_mode="dropout" if members is None else "params_stack")
        if members is not None:
            spec = dataclasses.replace(spec, **{"member_chunk": 1, **members_fields})
    torch.cuda.synchronize()
    return cfg, built, make_sampler(built, spec, members=members)


def test_images(cfg):
    import numpy as np
    import torch

    from diffuncertainty_tpu_torch.data.augment import normalize_batch
    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset

    ds = toy128_dataset(HW)
    images = torch.from_numpy(np.stack([ds.load(i)["image"] for i in range(BATCH)])).cuda()
    aug = cfg.data.augmentations
    return normalize_batch(images, aug.mean, aug.std)


@contextlib.contextmanager
def counting_twins():
    """Counts, per kernel, the calls of its plain twin while the block runs:
    the attention gate's fp32 route and both wrappers' CPU route."""
    from diffuncertainty_tpu_torch.ops import attention
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn

    calls = {"qkv_attention": 0, "group_norm_act": 0}
    sites = ((attention, "qkv_attention_reference", "qkv_attention"),
             (ca, "qkv_attention_reference", "qkv_attention"),
             (gn, "group_norm_act_reference", "group_norm_act"))
    saved = [getattr(mod, name) for mod, name, _ in sites]

    def counter(fn, kernel):
        def twin(*args, **kwargs):
            calls[kernel] += 1
            return fn(*args, **kwargs)
        return twin

    try:
        for (mod, name, kernel), fn in zip(sites, saved):
            setattr(mod, name, counter(fn, kernel))
        yield calls
    finally:
        for (mod, name, _), fn in zip(sites, saved):
            setattr(mod, name, fn)


def counted_call(built, sampler, images, seed: int):
    """One sampler call with both kernels' launch counts set to 0 just before
    it and read just after, and every attention and GroupNorm input shape;
    fails if a kernel's plain twin ran in the call."""
    import torch

    from diffuncertainty_tpu_torch.models.unet import AttentionBlock, GroupNorm32
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn

    attn_seen, norm_seen = [], []
    hooks = []
    for m in (m for net in getattr(sampler, "modules", [built.module]) for m in net.modules()):
        if isinstance(m, AttentionBlock):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: attn_seen.append(tuple(args[0].shape))))
        elif isinstance(m, GroupNorm32):
            hooks.append(m.register_forward_pre_hook(lambda mod, args: norm_seen.append(
                (tuple(args[0].shape), str(args[0].dtype).split(".")[-1], mod.act))))
    n_attn = sum(isinstance(m, AttentionBlock) for m in built.module.modules())
    n_norm = sum(isinstance(m, GroupNorm32) for m in built.module.modules())
    torch.cuda.synchronize()
    with counting_twins() as twins:
        ca.reset_launch_count()
        gn.reset_launch_count()
        stack = sampler(images, torch.Generator("cuda").manual_seed(seed))
        torch.cuda.synchronize()
        launches = {"qkv_attention": ca.launch_count(), "group_norm_act": gn.launch_count()}
    for h in hooks:
        h.remove()
    if any(twins.values()):
        raise AssertionError(f"plain twins ran in the counted call: {twins}")
    return stack, launches, n_attn, n_norm, attn_seen, norm_seen


def check_stack(name: str, stack):
    import torch

    from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps

    groups = stack.groups.float()
    if not torch.isfinite(groups).all():
        raise AssertionError(f"{name}: non-finite probabilities in the stack")
    sum_err = (groups.sum(-1) - 1).abs().max().item()
    maps = uncertainty_heatmaps(stack.group_means.float(), sample_axis=0, class_axis=-1)
    decomp_err = (maps["TU"] - maps["AU"] - maps["EU"]).abs().max().item()
    log(f"{name}: groups {tuple(stack.groups.shape)}, max |sum_c p - 1| {sum_err:.2e}, "
        f"max |TU-AU-EU| {decomp_err:.2e}, mean EU {maps['EU'].mean().item():.4e}")
    if sum_err > 1e-5 or decomp_err > 1e-5 or (maps["EU"] < -1e-6).any():
        raise AssertionError(f"{name}: stack is not a simplex or the heatmaps do not decompose")


def check_tracks(name: str, stack, stack32):
    diff = (stack.mean - stack32.mean).abs()
    agree = (stack.mean.argmax(-1) == stack32.mean.argmax(-1)).float().mean().item()
    log(f"bf16 vs fp32 {name}, same draws: mean |dp| {diff.mean().item():.3e}, "
        f"max |dp| {diff.max().item():.3e}, argmax agreement {agree:.5f}")
    if diff.mean().item() > 0.01 or agree < 0.99:
        raise AssertionError(f"bf16 {name} does not track the fp32 path")


def time_calls(sampler, images, n_calls: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_calls):
        sampler(images, torch.Generator("cuda").manual_seed(1 + i))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_calls


def check_launches(name: str, launches: dict, expected: dict):
    log(f"{name}: launches per call {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"{name}: kernel launches {launches} != {expected}")


def phase_main_path(attn_checked: set, norm_checked: set):
    import torch

    cfg, built, sampler = build_path("bf16", separable=True)
    images = test_images(cfg)
    stack, launches, n_attn, n_norm, attn_seen, norm_seen = counted_call(
        built, sampler, images, 0)
    check_launches("softmax path", launches, {"qkv_attention": n_attn, "group_norm_act": n_norm})
    if n_attn != 11 or n_norm != 56:
        raise AssertionError(f"unet16 has {n_attn} AttentionBlocks and {n_norm} GroupNorms")
    shapes = {(b, hh * ww, c) for b, hh, ww, c in attn_seen}
    if shapes != attn_checked:
        raise AssertionError(f"main path attention shapes {shapes} != checked {attn_checked}")
    if set(norm_seen) != norm_checked:
        raise AssertionError(f"main path norm sites {set(norm_seen) - norm_checked} unchecked")
    attn_calls = {s: sum(1 for b, hh, ww, c in attn_seen if (b, hh * ww, c) == s) for s in shapes}
    check_stack("softmax path", stack)

    # the fp32 path with the same generator draws the same TTA params and
    # dropout masks: the bf16 result must track it
    _, _, sampler32 = build_path("fp32", separable=True)
    stack32 = sampler32(images, torch.Generator("cuda").manual_seed(0))
    check_tracks("softmax path", stack, stack32)
    del sampler32, stack32

    per_call = time_calls(sampler, images, 5)
    log(f"softmax path bf16: {per_call * 1e3:.1f} ms per call of {BATCH} images x {MEMBERS} "
        f"members -> {BATCH / per_call:.2f} img/s")
    return launches, attn_calls, norm_seen, BATCH / per_call


def phase_diffusion(norm_checked: set):
    import torch

    cfg, built, sampler = build_path("bf16", separable=True, model="diffusion")
    images = test_images(cfg)
    stack, launches, n_attn, n_norm, _, norm_seen = counted_call(built, sampler, images, 0)
    check_launches("diffusion path", launches, {"qkv_attention": DDIM_STEPS * n_attn,
                                                "group_norm_act": DDIM_STEPS * n_norm})
    if set(norm_seen) != norm_checked:
        raise AssertionError(f"diffusion norm sites {set(norm_seen) - norm_checked} unchecked")
    check_stack("diffusion path", stack)
    if stack.groups.shape != (TRAJECTORIES, 1, BATCH, HW, HW, 2):
        raise AssertionError(f"diffusion stack shape {tuple(stack.groups.shape)}")

    # the fp32 model from the same generator seed starts from the same x_init
    _, _, sampler32 = build_path("fp32", separable=True, model="diffusion")
    stack32 = sampler32(images, torch.Generator("cuda").manual_seed(0))
    check_tracks("diffusion path", stack, stack32)
    del sampler32, stack32

    per_call = time_calls(sampler, images, 3)
    log(f"diffusion path bf16: {per_call * 1e3:.1f} ms per call of {BATCH} images x "
        f"{TRAJECTORIES} DDIM-{DDIM_STEPS} trajectories -> {BATCH / per_call:.3f} img/s")
    return launches, BATCH / per_call


def phase_generative16(model: str, attn_checked: set, norm_checked: set):
    """The SSN or prob-U-Net path: one counted 16-row call, the stack, the
    SSN's covariance failures, bf16 against fp32 from the same draws, and
    the time per call."""
    import torch

    cfg, built, sampler = build_path("bf16", separable=True, model=model)
    images = test_images(cfg)
    stack, launches, _, _, attn_seen, norm_seen = counted_call(built, sampler, images, 0)
    n_attn, n_norm = GENERATIVE16_LAUNCHES[model]
    check_launches(f"{model} path", launches, {"qkv_attention": n_attn, "group_norm_act": n_norm})
    if (len(attn_seen), len(norm_seen)) != (n_attn, n_norm):
        raise AssertionError(f"{model}: {len(attn_seen)} attention and {len(norm_seen)} "
                             f"GroupNorm calls seen, expected {n_attn} and {n_norm}")
    shapes = {(b, hh * ww, c) for b, hh, ww, c in attn_seen}
    if not shapes <= attn_checked:
        raise AssertionError(f"{model} attention shapes {shapes - attn_checked} unchecked")
    if not set(norm_seen) <= norm_checked:
        raise AssertionError(f"{model} norm sites {set(norm_seen) - norm_checked} unchecked")
    attn_calls = {s: sum(1 for b, hh, ww, c in attn_seen if (b, hh * ww, c) == s) for s in shapes}
    check_stack(f"{model} path", stack)
    if stack.groups.shape != (SAMPLES, 1, BATCH, HW, HW, 2):
        raise AssertionError(f"{model} stack shape {tuple(stack.groups.shape)}")
    if model == "ssn":
        from diffuncertainty_tpu_torch.models.ssn import build_distribution

        with torch.no_grad():
            out = built.module(images)
        failed = int(build_distribution(out.ssn_mean, out.ssn_cov_diag,
                                        out.ssn_cov_factor).cov_failed.sum())
        log(f"ssn path: cov_failed {failed} of {BATCH} elements")
        if failed:
            raise AssertionError(f"ssn: the covariance failed for {failed} elements")

    # the fp32 model from the same generator seed takes the same draws
    _, _, sampler32 = build_path("fp32", separable=True, model=model)
    stack32 = sampler32(images, torch.Generator("cuda").manual_seed(0))
    check_tracks(f"{model} path", stack, stack32)
    del sampler32, stack32

    per_call = time_calls(sampler, images, 10)
    log(f"{model} path bf16: {per_call * 1e3:.2f} ms per call of {BATCH} images x {SAMPLES} "
        f"samples -> {BATCH / per_call:.2f} img/s")
    return launches, attn_calls, norm_seen, BATCH / per_call


def median_call_s(sampler, images, n_calls: int) -> float:
    """Median host time of ``n_calls`` synchronized sampler calls."""
    import torch

    times = []
    for i in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler(images, torch.Generator("cuda").manual_seed(1 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def member_overheads(built, members: dict, n_calls: int = 5) -> dict:
    """Host time of what a stacked member adds to a forward: binding its
    weights with ``functional_call`` (on a module that only holds the
    network, so no forward runs) and casting all its float32 weights to
    bf16, per call of 16 members (medians of ``n_calls``)."""
    import torch
    from torch import nn

    class Bind(nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self):
            return None

    bind = Bind(built.module)
    states = [{f"net.{k}": v[m] for k, v in members.items()} for m in range(MEMBERS)]

    def bind_all():
        for st in states:
            torch.func.functional_call(bind, st, ())

    def cast_all():
        for m in range(MEMBERS):
            for v in members.values():
                v[m].to(torch.bfloat16)

    out = {}
    for name, fn in (("functional_call_ms", bind_all), ("weight_casts_ms", cast_all)):
        times = []
        for _ in range(n_calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times) * 1e3
    return out


def phase_ensemble(attn_checked16: set, norm_checked16: set):
    """The ensemble path: one counted call (16 member forwards at 16 rows),
    the stack and its EU, bf16 against fp32 with the same members and draws,
    the median time of 10 calls, and the member overheads."""
    import torch

    t0 = time.perf_counter()
    cfg, built, sampler = build_path("bf16", separable=True, model="ensemble")
    members = ensemble_members()
    log(f"ensemble path: {MEMBERS} members drawn from the SWAG-diag moments "
        f"({sum(v[0].numel() for v in members.values())} weights each, "
        f"{sum(v.numel() * v.element_size() for v in members.values()) / 1e6:.1f} MB of "
        f"float32 on the card) in {time.perf_counter() - t0:.2f}s")
    images = test_images(cfg)
    stack, launches, n_attn, n_norm, attn_seen, norm_seen = counted_call(built, sampler,
                                                                         images, 0)
    check_launches("ensemble path", launches, {"qkv_attention": MEMBERS * n_attn,
                                               "group_norm_act": MEMBERS * n_norm})
    if (n_attn, n_norm) != (11, 56):
        raise AssertionError(f"unet16 has {n_attn} AttentionBlocks and {n_norm} GroupNorms")
    shapes = {(b, hh * ww, c) for b, hh, ww, c in attn_seen}
    if not shapes <= attn_checked16:
        raise AssertionError(f"ensemble attention shapes {shapes - attn_checked16} unchecked")
    if not set(norm_seen) <= norm_checked16:
        raise AssertionError(f"ensemble norm sites {set(norm_seen) - norm_checked16} unchecked")
    attn_calls = {s: sum(1 for b, hh, ww, c in attn_seen if (b, hh * ww, c) == s) for s in shapes}
    check_stack("ensemble path", stack)
    if stack.groups.shape != (MEMBERS, 1, BATCH, HW, HW, 2):
        raise AssertionError(f"ensemble stack shape {tuple(stack.groups.shape)}")
    mean_eu("ensemble path", stack)
    spread = (stack.groups.float() - stack.groups[:1].float()).abs().amax(dim=(1, 2, 3, 4, 5))
    log("ensemble path: max |p_m - p_0| per member group "
        + ", ".join(f"{v:.3f}" for v in spread.tolist()))
    if not (spread[1:] > 1e-3).all():
        raise AssertionError("ensemble members do not differ")

    # the fp32 path with the same members and generator seed takes the same draws
    _, _, sampler32 = build_path("fp32", separable=True, model="ensemble")
    stack32 = sampler32(images, torch.Generator("cuda").manual_seed(0))
    check_tracks("ensemble path", stack, stack32)
    del sampler32, stack32

    per_call = median_call_s(sampler, images, 10)
    overheads = member_overheads(built, members)
    log(f"ensemble path bf16: {per_call * 1e3:.2f} ms per call (median of 10) of {BATCH} "
        f"images x {MEMBERS} members -> {BATCH / per_call:.2f} img/s; per call, binding "
        f"{MEMBERS} members' weights (functional_call) {overheads['functional_call_ms']:.2f} ms, "
        f"casting them to bf16 {overheads['weight_casts_ms']:.2f} ms (the sampler casts them "
        f"once, when it is built)")
    return launches, attn_calls, norm_seen, BATCH / per_call, overheads


@contextlib.contextmanager
def recording_sites(sampler):
    """Records, while the block runs, the input shape of every attention
    call and (shape, dtype, act, members) of every GroupNorm call in the
    modules the sampler's forwards run."""
    from diffuncertainty_tpu_torch.models.unet import AttentionBlock, GroupNorm32

    attn_seen, norm_seen, hooks = [], [], []
    for m in (m for net in sampler.modules for m in net.modules()):
        if isinstance(m, AttentionBlock):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: attn_seen.append(tuple(args[0].shape))))
        elif isinstance(m, GroupNorm32):
            hooks.append(m.register_forward_pre_hook(lambda mod, args: norm_seen.append(
                (tuple(args[0].shape), str(args[0].dtype).split(".")[-1],
                 "none" if mod.act == "gelu" else mod.act, mod.members))))
    try:
        yield attn_seen, norm_seen
    finally:
        for h in hooks:
            h.remove()


def check_sites(sampler, images, attn_checked: set, norm_checked: set, seed: int
                ) -> tuple[list, list]:
    """Every attention and GroupNorm shape one (uncounted) call of the
    sampler gives the kernels, checked against the twins unless checked
    before (not timed); returns the new cases."""
    import torch

    with recording_sites(sampler) as (attn_seen, norm_seen):
        sampler(images, torch.Generator("cuda").manual_seed(99))
        torch.cuda.synchronize()
    attn_cases, norm_cases = [], []
    for b, hh, ww, c in sorted(set(attn_seen)):
        if (b, hh * ww, c) not in attn_checked:
            attn_cases.append(attention_case(b, hh * ww, c, 4, seed=seed + len(attn_cases),
                                             timed=False))
            attn_checked.add((b, hh * ww, c))
    for key in sorted(set(norm_seen)):
        if key not in norm_checked:
            shape, dt, act, members = key
            norm_cases.append(group_norm_case(shape, dt, act, seed=seed + 50 + len(norm_cases),
                                              timed=False, members=members))
            norm_checked.add(key)
    return attn_cases, norm_cases


def profiled_ms(sampler, images, calls: int = 3) -> tuple[float, dict]:
    """(wall ms by CUDA events, ``profile_main_path.device_ms``) per call over
    ``calls`` calls after a warm one; ``busy`` / wall is the busy share."""
    import torch

    from diffuncertainty_tpu_torch.tools.profile_main_path import device_ms

    sampler(images, torch.Generator("cuda").manual_seed(50))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for i in range(calls):
            sampler(images, torch.Generator("cuda").manual_seed(60 + i))
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / calls, device_ms(prof, calls)


def peak_memory_gib(sampler, images) -> float:
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sampler(images, torch.Generator("cuda").manual_seed(70))
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def folded_fp32_check() -> dict:
    """fp32, dropout 0, TTA off: the 16 members' logits from one folded
    256-row forward (``DiffUnet(members=16)``) and the folded sampler's
    stack against one member at a time, to atol 1e-5 and rtol 1e-4."""
    import torch

    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.models.unet import DiffUnet
    from diffuncertainty_tpu_torch.sampling.sampler import (SamplerSpec, _tile_rows, cast_stack,
                                                            make_sampler)

    cfg = load_config(data="lidc128", network="unet16", model="softmax", eu_method="none",
                      precision="fp32")
    built = build_model(cfg, device="cuda")
    members = ensemble_members()
    stack = cast_stack(built.module, members)
    images = test_images(cfg)
    with torch.device("meta"):
        folded = DiffUnet(**{**built.module.config, "members": MEMBERS}).eval()
    call = torch.func.functional_call
    with torch.no_grad():
        got = call(folded, stack, (_tile_rows(images, MEMBERS),)).logits
        ref = torch.cat([call(built.module, {k: v[m] for k, v in stack.items()}, (images,)).logits
                         for m in range(MEMBERS)])
    err = (got - ref).abs()
    bad = int((err > 1e-5 + 1e-4 * ref.abs()).sum())
    spec = dict(n_pred=1, n_members=MEMBERS, member_mode="params_stack")
    stacks = {name: make_sampler(built, SamplerSpec(**spec, **fields), members=members)(
        images, torch.Generator("cuda").manual_seed(0)).groups
        for name, fields in (("folded", dict(member_chunk=None, member_fold=True)),
                             ("chunk1", dict(member_chunk=1)))}
    p_err = (stacks["folded"] - stacks["chunk1"]).abs()
    p_bad = int((p_err > 1e-5 + 1e-4 * stacks["chunk1"].abs()).sum())
    out = {"logits_max_abs_err": err.max().item(), "logits_beyond": bad,
           "stack_max_abs_err": p_err.max().item(), "stack_beyond": p_bad}
    log(f"ensemble_folded fp32 (dropout 0, TTA off): folded vs one member at a time: logits "
        f"max |d| {out['logits_max_abs_err']:.3e} ({bad} beyond 1e-5 + 1e-4|ref|), stack max "
        f"|d| {out['stack_max_abs_err']:.3e} ({p_bad} beyond)")
    if bad or p_bad:
        raise AssertionError(f"folded fp32 ensemble differs from one member at a time: {out}")
    return out


def phase_ensemble_folded(smi: str, attn_checked: set, norm_checked: set) -> dict:
    """The 16-member SWAG-diag ensemble folded three ways (``FOLD_STRATEGIES``):
    each strategy's kernel shapes against the twins, its counted call, stack,
    EU, quality on 256 images, times, busy share and peak memory; the
    fp32 folded check."""
    import torch

    from diffuncertainty_tpu_torch.sampling import sampler as sampler_mod
    from diffuncertainty_tpu_torch.tools.quality import toy128_quality_eval

    stats, attn_cases, norm_cases = {}, [], []
    for i, (name, (fields, (n_attn, n_norm))) in enumerate(FOLD_STRATEGIES.items()):
        cfg, built, sampler = build_path("bf16", separable=True, model="ensemble", **fields)
        images = test_images(cfg)
        a, n = check_sites(sampler, images, attn_checked, norm_checked, seed=800 + 100 * i)
        attn_cases += a
        norm_cases += n
        stack, launches, _, _, _, _ = counted_call(built, sampler, images, 0)
        label = f"ensemble_folded {name} (blocks {sampler.blocks})"
        check_launches(label, launches, {"qkv_attention": n_attn, "group_norm_act": n_norm})
        check_stack(label, stack)
        if stack.groups.shape != (MEMBERS, 1, BATCH, HW, HW, 2):
            raise AssertionError(f"{label} stack shape {tuple(stack.groups.shape)}")
        eu = mean_eu(label, stack)
        t0 = time.perf_counter()
        q = toy128_quality_eval(built, sampler, cfg.data, batch=BATCH, hw=HW, device="cuda")
        log(f"quality {label} (256 test images, {time.perf_counter() - t0:.1f}s): {q}")
        for metric, ref in PARITY["ensemble_bf16"].items():
            if abs(q[metric] - ref) > BANDS[metric]:
                raise AssertionError(f"{label} {metric} {q[metric]:.5f} outside "
                                     f"{ref} +- {BANDS[metric]}")
        per_call = median_call_s(sampler, images, 10)
        wall_ms, dev = profiled_ms(sampler, images)
        peak = peak_memory_gib(sampler, images)
        stats[name] = {"blocks": sampler.blocks, "launches": launches, "mean_eu": eu,
                       "quality": q, "ms": per_call * 1e3, "img_s": BATCH / per_call,
                       "profiled_wall_ms": wall_ms, "device_ms": dev["busy"],
                       "device_sum_ms": dev["sum"], "streams": dev["streams"],
                       "busy_share": dev["busy"] / wall_ms if dev["busy"] > 0 else None,
                       "peak_memory_gib": peak}
        log(f"{label} bf16 on {smi}: {per_call * 1e3:.2f} ms per call (median of 10) -> "
            f"{BATCH / per_call:.2f} img/s; under the profiler {wall_ms:.2f} ms, device "
            f"{dev['busy']:.2f} ms (kernel times summed {dev['sum']:.2f} ms, "
            f"{dev['streams']} streams), busy share "
            + ("not measured" if not dev["busy"] else f"{dev['busy'] / wall_ms:.3f}")
            + f"; peak memory {peak:.2f} GiB")
        del sampler, built, stack
        torch.cuda.empty_cache()
    fastest = min(stats, key=lambda k: stats[k]["ms"])
    auto = sampler_mod.AUTO_MEMBER_CHUNK.get(("cuda", "softmax"), 1)
    auto_name = {None: "folded", 4: "chunk4", 1: "chunk1"}.get(auto, f"chunk{auto}")
    log(f"ensemble_folded: fastest strategy {fastest} ({stats[fastest]['ms']:.2f} ms); "
        f"member_chunk 'auto' for stacked softmax members on cuda is {auto!r} ({auto_name})"
        + ("" if auto_name == fastest else " -- not the fastest in this run"))
    return {"strategies": stats, "fastest": fastest, "auto": auto_name,
            "fp32": folded_fp32_check(), "attn_cases": attn_cases, "norm_cases": norm_cases}


def seeded_weights_(module, seed: int) -> None:
    """Random weights on every leaf from ``seed``: conv and dense kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            z = torch.randn(p.shape, generator=gen, device="cuda")
            if p.ndim >= 2:
                p.copy_(z / p[0].numel() ** 0.5)
            else:
                p.copy_((1.0 if name.endswith("weight") else 0.0) + 0.1 * z)
            if not p.abs().max() > 0:
                raise AssertionError(f"unet256 leaf {name} is all zero")


def phase_unet256(smi: str, attn_checked: set, norm_checked: set) -> dict:
    """unet256 (64 channels, mult 1,2,4,8,12, attention at the two deepest
    levels), seeded weights, 16 MC-dropout members x TTA in one 256-row bf16
    forward: the new shapes against the twins, the counted call, the call
    against the twins-forced call with the same draws, time and memory."""
    import torch

    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.sampling.sampler import SamplerSpec, make_sampler
    from diffuncertainty_tpu_torch.sampling.tta import TTAConfig

    cfg = load_config(data="lidc128", network="unet256", model="softmax", eu_method="dropout",
                      precision="bf16")
    built = build_model(cfg, device="cuda")
    seeded_weights_(built.module, UNET256_SEED)
    tta = TTAConfig(hflip_p=0.5, rotation_limit=22.5, scale_limit=(-0.2, 0.2),
                    separable_warp=True)
    sampler = make_sampler(built, SamplerSpec(n_pred=1, n_members=MEMBERS, member_mode="dropout",
                                              tta=True, tta_config=tta))
    images = test_images(cfg)
    n_params = sum(p.numel() for p in built.module.parameters())
    attn_cases, norm_cases = check_sites(sampler, images, attn_checked, norm_checked, seed=1200)
    stack, launches, n_attn, n_norm, _, _ = counted_call(built, sampler, images, 0)
    check_launches(f"unet256 ({n_params} weights)", launches,
                   {"qkv_attention": UNET256_LAUNCHES[0], "group_norm_act": UNET256_LAUNCHES[1]})
    if (n_attn, n_norm) != UNET256_LAUNCHES:
        raise AssertionError(f"unet256 has {n_attn} AttentionBlocks and {n_norm} GroupNorms")
    check_stack("unet256", stack)
    with torch.no_grad():
        with twins_forced():
            twin = sampler(images, torch.Generator("cuda").manual_seed(0))
    diff = (stack.mean.float() - twin.mean.float()).abs()
    agree = (stack.mean.argmax(-1) == twin.mean.argmax(-1)).float().mean().item()
    log(f"unet256 call vs the same call through both twins (same draws): mean |dp| "
        f"{diff.mean().item():.3e}, max |dp| {diff.max().item():.3e}, argmax agreement "
        f"{agree:.5f} (held to mean {TWIN_CALL_TOL[0]} and {TWIN_CALL_TOL[1]})")
    if diff.mean().item() > TWIN_CALL_TOL[0] or agree < TWIN_CALL_TOL[1]:
        raise AssertionError("unet256 through the kernels disagrees with the twins-forced call")
    per_call = median_call_s(sampler, images, 5)
    peak = peak_memory_gib(sampler, images)
    log(f"unet256 bf16 on {smi}: {per_call * 1e3:.2f} ms per call (median of 5) of {BATCH} "
        f"images x {MEMBERS} members -> {BATCH / per_call:.2f} img/s; peak memory {peak:.2f} GiB")
    out = {"launches": launches, "weights": n_params, "ms": per_call * 1e3,
           "img_s": BATCH / per_call, "peak_memory_gib": peak,
           "twin_call": {"mean_abs_dp": diff.mean().item(), "max_abs_dp": diff.max().item(),
                         "argmax_agreement": agree},
           "attn_cases": attn_cases, "norm_cases": norm_cases}
    del sampler, built, stack, twin
    torch.cuda.empty_cache()
    return out


def mean_eu(name: str, stack) -> float:
    """The mean EU over pixels of a stack's group means; fails if it is 0."""
    from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps

    eu = uncertainty_heatmaps(stack.group_means.float(), sample_axis=0, class_axis=-1)["EU"]
    eu_per_image = eu.flatten(1).mean(1)
    log(f"{name}: mean EU over pixels {eu.mean().item():.4e} (per image "
        + ", ".join(f"{v:.2e}" for v in eu_per_image.tolist()) + ")")
    if not eu.mean().item() > 0.0:
        raise AssertionError(f"{name}: members do not differ: EU is 0")
    return eu.mean().item()


def phase_hrnet():
    """The HRNet path: one counted call (one 256-row hrnet-s forward, no
    attention or GroupNorm launch), the stack and its EU, bf16 against fp32
    with the same draws, the median time of 10 calls."""
    import torch

    from diffuncertainty_tpu_torch.models.hrnet import BatchNorm, Conv

    cfg, built, sampler = build_path("bf16", separable=True, model="hrnet")
    images = test_images(cfg)
    # what the forward must do, from its shapes: conv multiply-adds, and the
    # bytes of every conv's and BatchNorm's input and output
    work = {"macs": 0, "bytes": 0}

    def count(mod, args, out):
        if isinstance(mod, Conv):
            work["macs"] += out.numel() * mod.weight[0].numel()
        work["bytes"] += args[0].numel() * args[0].element_size() + out.numel() * out.element_size()

    hooks = [m.register_forward_hook(count) for m in built.module.modules()
             if isinstance(m, (Conv, BatchNorm))]
    stack, launches, n_attn, n_norm, _, _ = counted_call(built, sampler, images, 0)
    for h in hooks:
        h.remove()
    log(f"hrnet path: {2 * work['macs'] / 1e9:.1f} GFLOP in its convs "
        f"({2 * work['macs'] / PEAK_BF16_FLOPS * 1e3:.3f} ms at the bf16 peak), "
        f"{work['bytes'] / 1e9:.2f} GB of conv and BatchNorm inputs and outputs "
        f"({work['bytes'] / PEAK_BYTES * 1e3:.3f} ms at the HBM peak) per call")
    check_launches("hrnet path", launches, {"qkv_attention": 0, "group_norm_act": 0})
    if (n_attn, n_norm) != (0, 0):
        raise AssertionError(f"hrnet-s has {n_attn} AttentionBlocks and {n_norm} GroupNorms")
    check_stack("hrnet path", stack)
    if stack.groups.shape != (MEMBERS, 1, BATCH, HW, HW, 2):
        raise AssertionError(f"hrnet stack shape {tuple(stack.groups.shape)}")
    eu = mean_eu("hrnet path", stack)

    # the fp32 path with the same generator draws the same TTA params and
    # final-dropout masks
    _, _, sampler32 = build_path("fp32", separable=True, model="hrnet")
    stack32 = sampler32(images, torch.Generator("cuda").manual_seed(0))
    check_tracks("hrnet path", stack, stack32)
    del sampler32, stack32

    per_call = median_call_s(sampler, images, 10)
    log(f"hrnet path bf16: {per_call * 1e3:.2f} ms per call (median of 10) of {BATCH} images x "
        f"{MEMBERS} members -> {BATCH / per_call:.2f} img/s")
    return launches, BATCH / per_call, eu


def build_multiclass():
    """bench.py's multiclass model (gta_toy, unet16, MC-dropout) with the
    trained label-switch weights, and its member sliding-window function."""
    import torch

    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.core.params import load_into
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.tools.multiclass_quality import member_sliding_window_fn

    cfg = load_config(data="gta_toy", network="unet16", model="softmax", eu_method="dropout",
                      precision="bf16")
    built = build_model(cfg, device="cuda")
    load_into(built.module, ASSET_MULTICLASS)
    fn = member_sliding_window_fn(built.module, window=MC_WINDOW, stride=MC_STRIDE,
                                  members=MC_MEMBERS)
    torch.cuda.synchronize()
    return cfg, built, fn


def multiclass_rows() -> int:
    """Tile rows of one multiclass member forward: windows per frame x frames."""
    from diffuncertainty_tpu_torch.infer.sliding_window import _window_offsets

    return MC_FRAMES * (len(_window_offsets(MC_SIZE[0], MC_WINDOW, MC_STRIDE))
                        * len(_window_offsets(MC_SIZE[1], MC_WINDOW, MC_STRIDE)))


def phase_multiclass(attn_checked: set, norm_checked: set):
    """The multiclass path: one counted call (8 members, each one 168-row
    unet16 forward), the stitched stack, frames/s from CUDA-event times of 5
    calls after the first."""
    import torch

    from diffuncertainty_tpu_torch.data.augment import normalize_batch
    from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import event_ms
    from diffuncertainty_tpu_torch.tools.multiclass_quality import gta_toy_frames

    t0 = time.perf_counter()
    frames, _ = gta_toy_frames(MC_FRAMES, MC_SIZE, MC_WINDOW, MC_SEED)
    log(f"multiclass path: gta-toy {frames.shape} generated or found in "
        f"{time.perf_counter() - t0:.2f}s")
    cfg, built, fn = build_multiclass()
    aug = cfg.data.augmentations
    x = normalize_batch(torch.from_numpy(frames).cuda(), aug.mean, aug.std)
    stack, launches, n_attn, n_norm, attn_seen, norm_seen = counted_call(built, fn, x, MC_SEED)
    check_launches("multiclass path", launches, {"qkv_attention": MC_MEMBERS * n_attn,
                                                 "group_norm_act": MC_MEMBERS * n_norm})
    if (n_attn, n_norm) != (11, 56):
        raise AssertionError(f"unet16 has {n_attn} AttentionBlocks and {n_norm} GroupNorms")
    shapes = {(b, hh * ww, c) for b, hh, ww, c in attn_seen}
    if shapes != attn_checked:
        raise AssertionError(f"multiclass attention shapes {shapes} != checked {attn_checked}")
    if set(norm_seen) != norm_checked:
        raise AssertionError(f"multiclass norm sites {set(norm_seen) ^ norm_checked} unchecked")
    attn_calls = {s: sum(1 for b, hh, ww, c in attn_seen if (b, hh * ww, c) == s) for s in shapes}
    want = (MC_MEMBERS, MC_FRAMES) + tuple(MC_SIZE) + (built.num_classes,)
    if tuple(stack.shape) != want or not torch.isfinite(stack).all():
        raise AssertionError(f"multiclass stack {tuple(stack.shape)} (expected {want}) or "
                             f"non-finite values")
    sum_err = (stack.float().sum(-1) - 1).abs().max().item()
    maps = uncertainty_heatmaps(stack.float(), sample_axis=0, class_axis=-1)
    decomp_err = (maps["TU"] - maps["AU"] - maps["EU"]).abs().max().item()
    log(f"multiclass path: stack {tuple(stack.shape)}, max |sum_c p - 1| {sum_err:.2e}, "
        f"max |TU-AU-EU| {decomp_err:.2e}, mean TU {maps['TU'].mean().item():.4e}, "
        f"mean EU {maps['EU'].mean().item():.4e}")
    if sum_err > 1e-4 or decomp_err > 1e-4 or not maps["EU"].mean().item() > 0.0:
        raise AssertionError("multiclass stack is not a simplex, its heatmaps do not "
                             "decompose, or its members do not differ")
    del stack, maps
    gens = iter(range(100, 200))
    ms = event_ms(lambda: fn(x, torch.Generator("cuda").manual_seed(next(gens))), runs=5,
                  warmup=1)
    log(f"multiclass path bf16: {ms:.2f} ms per call (CUDA events, median of 5 after one) of "
        f"{MC_FRAMES} frames {MC_SIZE[0]}x{MC_SIZE[1]} x {MC_MEMBERS} members, "
        f"{multiclass_rows()} rows per member forward -> {MC_FRAMES / ms * 1e3:.3f} frames/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del x
    torch.cuda.empty_cache()
    return launches, attn_calls, norm_seen, MC_FRAMES / ms * 1e3


def softmax_job_checkpoint(tmp: Path):
    """A port checkpoint of the softmax asset (bf16, MC-dropout) whose config
    names the toy-128 data directory, written under ``tmp``; and the toy
    ``id`` dataset."""
    from diffuncertainty_tpu_torch.core.checkpoint import save_checkpoint
    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.core.params import load_params_npz
    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset

    ds = toy128_dataset(HW)
    cfg = load_config(data="lidc128", network="unet16", model="softmax", eu_method="dropout",
                      precision="bf16", overrides={"data": {
                          "data_input_dir": str(ds.base_dir), "split_name": "default"}})
    ckpt = save_checkpoint(tmp / "v0" / "checkpoints" / "last",
                           {"params": load_params_npz(ASSET)}, cfg, epoch=0)
    return ckpt, ds


def run_infer_job(label: str, argv: list[str], timeout: int = 600) -> tuple[list[dict], float]:
    """``python -m diffuncertainty_tpu_torch.infer`` as a subprocess, which
    must exit 0: its summary per split and its wall, the process included."""
    import ast

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "diffuncertainty_tpu_torch.infer", *argv],
                         cwd=REPO, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"{label}: the inference job exited {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    summaries = [ast.literal_eval(line) for line in out.stdout.splitlines()
                 if line.startswith("{'split'")]
    log(f"{label}: exit 0 in {wall:.1f}s (process included): {summaries}")
    return summaries, wall


def counted_job_batch(label: str, job, seed: int, attn_checked: set, norm_checked: set,
                      split: str = "id"):
    """One batch of the job's ``split`` through its sampler and batch
    metrics with the launches counted around it (11 / 56, no twin), every
    shape it gives the kernels checked before; returns the launches, the
    batch function and its images."""
    import torch

    from diffuncertainty_tpu_torch.data.loader import BatchLoader

    batch = next(iter(BatchLoader(job._dataset(split), BATCH, drop_last=False)))
    images = job.normalize(batch["image"])
    gt = torch.from_numpy(batch["seg"]).cuda()
    num_raters = torch.from_numpy(batch["num_raters"]).cuda()

    def job_batch(x, generator):
        stack = job._sample_stack(x, generator)
        return stack, job.metrics_fn(stack, gt, num_raters)

    (stack, _), launches, _, _, attn_seen, norm_seen = counted_call(
        job.built, job_batch, images, seed)
    check_launches(label, launches, {"qkv_attention": 11, "group_norm_act": 56})
    shapes = {(b, hh * ww, c) for b, hh, ww, c in attn_seen}
    if not shapes <= attn_checked or not set(norm_seen) <= norm_checked:
        raise AssertionError(f"{label}: unchecked attention shapes {shapes - attn_checked} "
                             f"or norm sites {set(norm_seen) - norm_checked}")
    check_stack(label, stack)
    return launches, job_batch, images


def phase_infer(smi: str, attn_checked: set, norm_checked: set):
    """The inference job on a port checkpoint of the softmax path: the
    user's entry point as a subprocess over the toy-128 ``id`` split, its
    results tree and quality, then one batch of the same job in process
    with the launch counts read around it."""
    import tempfile

    import numpy as np
    import torch

    from diffuncertainty_tpu_torch.infer.image_io import read_tiff
    from diffuncertainty_tpu_torch.infer.runner import InferenceConfig, UncertaintyInference
    from diffuncertainty_tpu_torch.metrics.aurc import aurc

    seed = 777
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, ds = softmax_job_checkpoint(Path(tmp))
        n_images = len(ds)
        argv = ["--checkpoint_paths", str(ckpt), "--test_split", "id", "--n_pred", "1",
                "--n_models", str(MEMBERS), "--tta", "--test_batch_size", str(BATCH),
                "--seed", str(seed), "--save_dir", str(Path(tmp) / "results")]
        (summary,), _ = run_infer_job("infer job", argv)
        out_dir = Path(summary["out_dir"])
        metrics = json.loads((out_dir / "metrics.json").read_text())
        likelihood = json.loads((out_dir / "likelihood.json").read_text())
        if not (summary["n_images"] == len(metrics) == len(likelihood) == n_images):
            raise AssertionError(f"infer job: {summary['n_images']} images, {len(metrics)} "
                                 f"metrics and {len(likelihood)} likelihood records, expected "
                                 f"{n_images}")
        pngs = sorted(p.name for p in (out_dir / "pred_seg").glob("*.png"))
        want = sorted(f"{i}_{tag}.png" for i in metrics
                      for tag in ["mean"] + [f"{g + 1:02d}" for g in range(MEMBERS)])
        if pngs != want:
            raise AssertionError(f"infer job: {len(pngs)} PNGs, expected {len(want)} "
                                 f"({MEMBERS + 1} per image)")
        tu_means, decomp_err = [], 0.0
        for image_id in metrics:
            tu, au, eu = (read_tiff(out_dir / k / f"{image_id}.tif") for k in ("TU", "AU", "EU"))
            if tu.shape != (HW, HW) or tu.min() < 0 or not np.isfinite(tu).all():
                raise AssertionError(f"infer job: TU of {image_id} is not a finite non-negative "
                                     f"{HW}x{HW} map")
            decomp_err = max(decomp_err, float(np.abs(tu - au - eu).max()))
            tu_means.append(float(tu.mean()))
        if decomp_err > 1e-5:
            raise AssertionError(f"infer job: max |TU - AU - EU| {decomp_err:.2e} > 1e-5")
        dices = np.array([r["metrics"]["dice"] for r in metrics.values()])
        quality = {"dice": float(dices.mean()),
                   "ged_bma": float(np.mean([r["metrics"]["ged_bma"] for r in metrics.values()])),
                   "aurc": float(aurc(1.0 - dices, -np.asarray(tu_means))),
                   "mean_NLL": float(np.mean([r["mean_NLL"] for r in likelihood.values()]))}
        log(f"infer job quality ({n_images} images): {quality}, max |TU-AU-EU| "
            f"{decomp_err:.2e}")
        for metric in ("dice", "ged_bma", "aurc"):
            ref = PARITY["bf16"][metric]
            if abs(quality[metric] - ref) > BANDS[metric]:
                raise AssertionError(f"infer job {metric} {quality[metric]:.5f} outside "
                                     f"{ref} +- {BANDS[metric]}")

        # the same job in process: one batch through its sampler and metrics
        icfg = InferenceConfig(n_pred=1, n_models=MEMBERS, tta=True, batch_size=BATCH,
                               seed=seed, save_dir=str(Path(tmp) / "results"))
        job = UncertaintyInference([ckpt], icfg)
    launches, job_batch, images = counted_job_batch("infer path", job, seed, attn_checked,
                                                    norm_checked)
    times = []
    for i in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        job_batch(images, torch.Generator("cuda").manual_seed(i))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    batch_ms = statistics.median(times)
    # the warm job in process over the whole split, with its writes and
    # without them (metrics only): what the first run's img/s is made of
    warm = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, outputs in (("warm", True), ("warm_metrics_only", False)):
            job.icfg.save_outputs, job.icfg.save_dir = outputs, str(Path(tmp) / label)
            warm[label] = job.run_split("id")["images_per_sec"]
    log(f"infer job on {smi}: {summary['images_per_sec']:.2f} img/s over the split in a new "
        f"process, writes included; in process after the counted batch {warm['warm']:.2f} "
        f"img/s with the writes, {warm['warm_metrics_only']:.2f} without them; one batch of "
        f"{BATCH} images ({MEMBERS} members x TTA, sampler and batch metrics) {batch_ms:.2f} ms "
        f"(CUDA events, median of 5) -> {BATCH / batch_ms * 1e3:.2f} img/s without the host's "
        f"loading, copies and writes")
    return launches, {"images_per_sec": summary["images_per_sec"], **warm,
                      "batch_ms": batch_ms, **quality}


EVAL_SPLITS = ("val", "id", "ood_noise", "ood_blur")
EVAL_PAIRS = (("id", "ood_noise"), ("id", "ood_blur"))
# every task of the evaluation matrix but the two cleanups
EVAL_TASKS = ("threshold", "area", "aggregation", "ood_detection", "failure_detection",
              "ambiguity_modeling", "calibration")


def evaluate_job_tree(version_dir: Path, splits_path: Path, data_dir: Path,
                      pred_model: str = "softmax") -> tuple[dict, float]:
    """``python -m diffuncertainty_tpu_torch.evaln.experiments --config`` with
    a JSON config over one version of the job's results tree (``val``
    fitting the Platt parameters, both OoD shifts paired with ``id``), which
    must exit 0; then the checks: every task file there, the ``id`` split's
    TU image-level AURC equal to ``metrics/aurc.py::aurc`` of 1 - Dice
    against -mean TU from the tree's own ``metrics.json`` and TIFFs (1e-9),
    every AUROC, detection rate and calibration error finite in [0, 1],
    every NCC finite in [-1, 1], the Platt parameters finite. Returns the
    headline numbers and the command's wall."""
    import numpy as np

    from diffuncertainty_tpu_torch.infer.image_io import read_tiff
    from diffuncertainty_tpu_torch.metrics.aurc import aurc

    config = {"base_path": str(version_dir.parents[3]),
              "experiments": [{"iter_params": {"pred_model": [pred_model]},
                               "exp_name": version_dir.parents[2].name,
                               "naming_scheme_version": f"{version_dir.parent.name}/"
                                                        f"{version_dir.name}",
                               "n_pred": int(version_dir.parents[1].name[len("test_results"):])}],
              "tasks": list(EVAL_TASKS), "paired_splits": [list(p) for p in EVAL_PAIRS],
              "calibration_val_split": "val",
              "dataset": {"splits_path": str(splits_path), "data_input_dir": str(data_dir)}}
    cfg_path = version_dir.parents[3] / "eval_config.json"
    cfg_path.write_text(json.dumps(config, indent=2))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "diffuncertainty_tpu_torch.evaln.experiments",
                          "--config", str(cfg_path)],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the evaluation matrix exited {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    want = [version_dir / n for n in ("quantile_analysis.json", "threshold_analysis.json",
                                      "ood_detection.json", "platt_scale_params.json")]
    for split in EVAL_SPLITS:
        want += [version_dir / split / n for n in (
            "area.json", "aggregated_TU.json", "aggregated_AU.json", "aggregated_EU.json",
            "failure_detection.json", "ambiguity_modeling.json")]
        if split != "val":  # the Platt split is not calibrated against itself
            want.append(version_dir / split / "calibration.json")
    missing = [str(p.relative_to(version_dir)) for p in want if not p.is_file()]
    if missing:
        raise AssertionError(f"evaluation: task files missing: {missing}")

    def read(*parts):
        return json.loads(version_dir.joinpath(*parts).read_text())

    def check_range(name, value, lo=0.0, hi=1.0):
        if not (math.isfinite(value) and lo <= value <= hi):
            raise AssertionError(f"evaluation: {name} = {value} not finite in [{lo}, {hi}]")

    # the failure task against the AURC of the tree's own records
    metrics = read("id", "metrics.json")
    dices, tu_means = [], []
    for image_id in sorted(metrics):
        dices.append(metrics[image_id]["metrics"]["dice"])
        tu = read_tiff(version_dir / "id" / "TU" / f"{image_id}.tif")
        tu_means.append(float(np.sum(tu) / tu.size))
    direct = float(aurc(1.0 - np.asarray(dices), -np.asarray(tu_means)))
    failure = read("id", "failure_detection.json")["mean"]
    task_aurc = failure["TU"]["image_level"]["metrics"]["aurc"]
    if abs(task_aurc - direct) > 1e-9:
        raise AssertionError(f"evaluation: failure_detection's TU image-level AURC {task_aurc} "
                             f"!= {direct} from metrics.json and the TIFFs")
    ood = read("ood_detection.json")
    numbers = {"aurc": task_aurc,
               "eaurc": failure["TU"]["image_level"]["metrics"]["eaurc"], "auroc": {}}
    for id_split, ood_split in EVAL_PAIRS:
        per_unc = ood[f"{id_split}&{ood_split}"]["mean"]
        for unc, aggs in per_unc.items():
            for agg, rec in aggs.items():
                for key, value in rec["metrics"].items():
                    check_range(f"{ood_split} {unc} {agg} {key}", value)
            numbers["auroc"][f"{ood_split} {unc}"] = {
                agg: per_unc[unc][agg]["metrics"]["auroc"]
                for agg in ("image_level", "patch_level")}
    for unc, ab in read("platt_scale_params.json").items():
        if not all(math.isfinite(v) for v in ab.values()):
            raise AssertionError(f"evaluation: Platt parameters of {unc} not finite: {ab}")
    numbers["gece"], numbers["ncc"] = {}, {}
    for split in EVAL_SPLITS:
        for unc, rec in read(split, "ambiguity_modeling.json")["mean"].items():
            check_range(f"{split} {unc} ncc", rec["metrics"]["ncc"], -1.0, 1.0)
        numbers["ncc"][split] = {unc: rec["metrics"]["ncc"] for unc, rec in
                                 read(split, "ambiguity_modeling.json")["mean"].items()}
        if split == "val":
            continue
        calib = read(split, "calibration.json")
        for image_id, per_unc in calib.items():
            for unc, rec in per_unc.items():
                for key, value in rec["metrics"].items():
                    check_range(f"{split} {image_id} {unc} {key}", value)
        numbers["gece"][split] = {unc: rec["metrics"]["gece"]
                                  for unc, rec in calib["mean"].items()}
    return numbers, wall


def phase_eval(smi: str, attn_checked: set, norm_checked: set):
    """The job a ValUES user runs: the inference job with ``--include_eval``
    over the toy-128 val, id and OoD splits on a port checkpoint of the
    softmax asset (a subprocess), the same job's launches counted around one
    in-process batch, then the evaluation matrix's command line over the tree
    it wrote, every task but the cleanups."""
    import tempfile

    from diffuncertainty_tpu_torch.infer.runner import InferenceConfig, UncertaintyInference

    seed = 777
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, ds = softmax_job_checkpoint(Path(tmp))
        argv = ["--checkpoint_paths", str(ckpt), "--test_split", *EVAL_SPLITS, "--n_pred", "1",
                "--n_models", str(MEMBERS), "--tta", "--test_batch_size", str(BATCH),
                "--seed", str(seed), "--save_dir", str(Path(tmp) / "results"), "--include_eval"]
        summaries, job_wall = run_infer_job("eval job", argv, timeout=900)
        counts = {s["split"]: s["n_images"] for s in summaries}
        expected = {split: len(ds) if split == "id" else 16 for split in EVAL_SPLITS}
        if counts != expected:
            raise AssertionError(f"eval job: images per split {counts}, expected {expected}")
        version_dir = Path(summaries[0]["out_dir"]).parent
        # the job's own --include_eval chain wrote these before the matrix runs
        chain = [version_dir / "threshold_analysis.json"] + [
            version_dir / split / name for split in EVAL_SPLITS
            for name in ("area.json", "aggregated_TU.json", "failure_detection.json",
                         "ambiguity_modeling.json")]
        if not all(p.is_file() for p in chain):
            raise AssertionError("eval job: --include_eval did not write its chain's files")
        splits_path = ds.base_dir / "splits" / "default" / "firstCycle" / "splits.pkl"
        numbers, eval_wall = evaluate_job_tree(version_dir, splits_path, ds.base_dir)
        job = UncertaintyInference([ckpt], InferenceConfig(
            n_pred=1, n_models=MEMBERS, tta=True, batch_size=BATCH, seed=seed,
            save_dir=str(Path(tmp) / "results")))
    launches, _, _ = counted_job_batch("eval path", job, seed, attn_checked, norm_checked)
    ref = PARITY["bf16"]["aurc"]
    if abs(numbers["aurc"] - ref) > BANDS["aurc"]:
        raise AssertionError(f"evaluation: AURC {numbers['aurc']:.5f} outside {ref} +- "
                             f"{BANDS['aurc']}")
    infer_s = sum(s["seconds"] for s in summaries)
    for shift_unc, per_agg in numbers["auroc"].items():
        log(f"eval AUROC {shift_unc}: image_level {per_agg['image_level']:.5f}, patch_level "
            f"{per_agg['patch_level']:.5f}")
    log(f"eval id split TU image_level: AURC {numbers['aurc']:.6f} (band {ref} +- "
        f"{BANDS['aurc']}), E-AURC {numbers['eaurc']:.6f}; gECE {numbers['gece']}; "
        f"NCC {numbers['ncc']}")
    log(f"eval on {smi}: the job with --include_eval {job_wall:.1f}s over "
        f"{sum(counts.values())} images (process included; its splits' inference "
        f"{infer_s:.1f}s, the rest the default chain and start-up), the evaluation matrix's "
        f"command line {eval_wall:.1f}s (host)")
    return launches, {"job_wall_s": job_wall, "job_inference_s": infer_s,
                      "eval_wall_s": eval_wall, **numbers}


# The lidc_import path: 16 seeded synthetic CT scans (one patient each,
# 96x96x48 voxels at 0.7x0.7x2.5 mm, intensities windowed to [0, 1]) with
# 1-2 nodules of 1-4 rater balls (3-8 mm) each, cut to the 128-px crops;
# the LIDC importer with its four OOD copies; the job over the id split and
# the shifts on a reference-format checkpoint of the softmax asset
LIDC_PATIENTS, LIDC_SEED = 16, 1818
LIDC_SHAPE, LIDC_SPACING = (96, 96, 48), (0.7, 0.7, 2.5)
LIDC_SHIFTS = ("ood_noise", "ood_blur", "ood_contrast", "ood_jpeg")
# the reference's MODEL.DROPOUT for unet16 + MC-dropout (eu_method/dropout.yaml's rate)
LIDC_DROPOUT = 0.2


def synthetic_ct_scans(n: int, seed: int) -> list:
    """``n`` scans of ``LIDC_SHAPE`` voxels: parenchyma 0.15 with smoothed
    noise, each nodule a soft ball of +0.55, and each rater's annotation a
    ball around it (centre jittered in-plane, radius x0.8-1.25), stored
    sparse at an offset as pylidc's masks are. Centres sit within 0.2 of a
    slice so that every rater's ball holds a voxel; nodules of one scan are
    more than 25 mm apart, so each clusters alone."""
    import numpy as np
    from scipy import ndimage

    from diffuncertainty_tpu_torch.data.lidc_raw import RaterAnnotation, ScanRecord

    rng = np.random.default_rng(seed)
    spacing = np.asarray(LIDC_SPACING)
    grid = np.meshgrid(*[np.arange(s) * sp for s, sp in zip(LIDC_SHAPE, spacing)],
                       indexing="ij")  # voxel centres in mm

    def dist(center_mm):
        return np.sqrt(sum((g - c) ** 2 for g, c in zip(grid, center_mm)))

    scans = []
    for p in range(n):
        vol = 0.15 + 0.1 * ndimage.gaussian_filter(rng.standard_normal(LIDC_SHAPE), 1.0)
        anns, centers = [], []
        for _ in range(int(rng.integers(1, 3))):
            while True:
                c = np.array([rng.uniform(20, 76), rng.uniform(20, 76),
                              rng.integers(12, 37) + rng.uniform(-0.2, 0.2)]) * spacing
                if all(np.linalg.norm(c - o) > 25.0 for o in centers):
                    break
            centers.append(c)
            radius = rng.uniform(1.5, 4.0)
            vol += 0.55 * np.clip(radius + 0.5 - dist(c), 0.0, 1.0)
            for _ in range(int(rng.integers(1, 5))):
                mask = dist(c + np.r_[rng.normal(0, 0.35, 2), 0.0]) <= radius * rng.uniform(
                    0.8, 1.25)
                idx = np.argwhere(mask)
                lo, hi = idx.min(axis=0), idx.max(axis=0) + 1
                anns.append(RaterAnnotation(
                    mask=mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]],
                    offset=tuple(int(v) for v in lo),
                    features={"subtlety": int(rng.integers(1, 6)),
                              "malignancy": int(rng.integers(1, 6))}))
        scans.append(ScanRecord(scan_id=p + 1, patient_id=f"LIDC-IDRI-{p + 1:04d}",
                                volume=np.clip(vol, 0.0, 1.0).astype(np.float32),
                                spacing=LIDC_SPACING, annotations=anns,
                                series_uid=f"1.3.6.1.4.1.14519.5.2.1.{seed}.{p + 1}"))
    return scans


def lidc_asset_config(data_dir=""):
    """The config the softmax asset serves with (unet16, MC-dropout, bf16)."""
    from diffuncertainty_tpu_torch.core.config import load_config

    return load_config(data="lidc128", network="unet16", model="softmax", eu_method="dropout",
                       precision="bf16", overrides={"data": {"data_input_dir": str(data_dir)}})


def lidc_reference_checkpoint(path: Path, data_dir: Path) -> Path:
    """A reference-format Lightning ``.ckpt`` of the softmax asset: the state
    dict in the reference's names (the port's mapping inverted) under
    ``model.`` and ``ema_model.module.``, and ``hyper_parameters`` for unet16
    and lidc128 in the reference's hydra layout, pickled as omegaconf
    containers (stand-in classes of omegaconf's names; no omegaconf here)."""
    import types

    import torch

    from diffuncertainty_tpu_torch.core.params import flax_to_torch, load_params_npz
    from diffuncertainty_tpu_torch.core.torch_import import build_mapping
    from diffuncertainty_tpu_torch.models.factory import build_model

    built = build_model(lidc_asset_config(data_dir), device="cpu")
    port = flax_to_torch(load_params_npz(ASSET))
    ref = {}
    for ref_key, port_key, transform in build_mapping(built.module).entries:
        if port_key in port:
            w = port[port_key]
            ref[ref_key] = w[..., None] if transform.__name__ == "_conv1d" else w
    if len(ref) != len(port):
        raise AssertionError(f"the mapping covers {len(ref)} of the asset's {len(port)} leaves")
    net = lidc_asset_config().network
    omegaconf = types.ModuleType("omegaconf")
    omegaconf.DictConfig = type("DictConfig", (dict,), {"__module__": "omegaconf"})
    omegaconf.ListConfig = type("ListConfig", (list,), {"__module__": "omegaconf"})
    d, lst = omegaconf.DictConfig, omegaconf.ListConfig
    model = d({"IN_CHANNELS": net.in_channels, "OUT_CHANNELS": net.out_channels,
               "MODEL_CHANNELS": net.model_channels,
               "NUM_RES_BLOCKS": lst(net.num_res_blocks),
               "NUM_MIDDLE_RES_BLOCKS": net.num_middle_res_blocks,
               "CHANNEL_MULT": lst(net.channel_mult),
               "ATTENTION_RESOLUTIONS": lst(net.attention_resolutions),
               "NUM_HEADS": net.num_heads, "DROPOUT": LIDC_DROPOUT})
    aug = d({"rotation_limit": 22.5, "scale_limit": lst([-0.2, 0.2]), "height": HW, "width": HW,
             "mean": lst([0.485, 0.456, 0.406]), "std": lst([0.229, 0.224, 0.225]),
             "augment_mult": 0.0, "TRAIN": lst([d({"HorizontalFlip": d({"p": 0.5})}),
                                                 d({"Rotate": d({"limit": 22.5})})])})
    payload = {"state_dict": {**{f"model.{k}": v for k, v in ref.items()},
                              **{f"ema_model.module.{k}": v for k, v in ref.items()}},
               "epoch": 0, "hyper_parameters": d({
                   "model": d({"cfg": d({"MODEL": model})}),
                   "data": d({"name": "lidc128", "num_classes": 2, "ignore_index": -1,
                              "data_input_dir": str(data_dir), "augmentations": aug})})}
    sys.modules["omegaconf"] = omegaconf
    try:
        torch.save(payload, path)
    finally:
        del sys.modules["omegaconf"]
    return path


def run_module(label: str, module: str, argv: list[str], timeout: int = 600) -> tuple[str, float]:
    """``python -m module argv`` as a subprocess that must exit 0: its
    standard output and wall."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO, capture_output=True,
                         text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"{label}: {module} exited {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return out.stdout, wall


def phase_lidc_import(smi: str, attn_checked: set, norm_checked: set):
    """Synthetic CT scans to the evaluated job through the user's entry
    points: the raw LIDC stage, ``python -m ...data.lidc_import`` with its
    four OOD copies, a reference-format checkpoint converted by ``python -m
    ...tools.import_reference_checkpoint`` (equal to the asset bit for bit),
    then ``python -m ...infer --include_eval`` over the id split and the
    shifts; in process, one counted batch (11 / 56), that batch's heatmaps
    against a sampler built from the asset, the job's loader on the native
    reader, and each shift's image-level AUROC of TU and EU."""
    import csv
    import pickle
    import tempfile

    import numpy as np
    import torch

    from diffuncertainty_tpu_torch.core.checkpoint import load_checkpoint
    from diffuncertainty_tpu_torch.core.params import flax_to_torch, load_into, load_params_npz
    from diffuncertainty_tpu_torch.data import lidc_raw, native_loader
    from diffuncertainty_tpu_torch.data.lidc_import import generate_ood_test_files
    from diffuncertainty_tpu_torch.data.loader import BatchLoader
    from diffuncertainty_tpu_torch.evaln.dataloader import ResultsReader
    from diffuncertainty_tpu_torch.evaln.tasks import ood_detection_paired
    from diffuncertainty_tpu_torch.infer.image_io import read_tiff
    from diffuncertainty_tpu_torch.infer.runner import InferenceConfig, UncertaintyInference
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
    from diffuncertainty_tpu_torch.sampling.sampler import make_sampler

    seed, walls = 777, {}
    splits = ("id",) + LIDC_SHIFTS
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        scans = synthetic_ct_scans(LIDC_PATIENTS, LIDC_SEED)
        walls["scans_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        crops = lidc_raw.save_crops(scans, tmp / "crops", lidc_raw.CropConfig.large())
        n_crops = len(list((crops / "images").glob("*.npy")))
        pkl = lidc_raw.crops_to_aggregated_pickle(
            crops, tmp / "data_lidc.pickle", {f"{s.scan_id:04d}": s.series_uid for s in scans})
        with open(tmp / "LIDC-IDRI_MetaData.csv", "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["Subject ID", "Series ID"])
            w.writerows((s.patient_id, s.series_uid) for s in scans)
        walls["crops_s"] = time.perf_counter() - t0
        with open(crops / "metadata.csv", newline="") as fh:
            if len(list(csv.DictReader(fh))) != n_crops:
                raise AssertionError("lidc_import: metadata.csv rows != crops")
        log(f"lidc_import: {LIDC_PATIENTS} scans ({sum(len(s.annotations) for s in scans)} "
            f"rater annotations) -> {n_crops} crops of 128x128 in {walls['crops_s']:.1f}s "
            f"(scans made in {walls['scans_s']:.1f}s)")

        _, walls["import_s"] = run_module(
            "lidc_import", "diffuncertainty_tpu_torch.data.lidc_import",
            ["--pickle-path", str(pkl), "--metadata-csv", str(tmp / "LIDC-IDRI_MetaData.csv"),
             "--out-root", str(tmp / "data"), "--image-size", str(HW), "--num-splits", "4",
             "--test-ratio", "0.2"])
        data_dir = tmp / "data" / f"origlidc{HW}"
        splits_path = data_dir / "splits" / "ood_aug" / "firstCycle" / "splits.pkl"
        folds = pickle.loads(splits_path.read_bytes())
        counts = {s: len(folds[0][s]) for s in splits}
        if len(folds) != 4 or not all(counts.values()) or any(
                len(list((data_dir / "preprocessed" / "augmented" / s / "images").glob("*.npy")))
                != counts["id"] for s in LIDC_SHIFTS):
            raise AssertionError(f"lidc_import: {len(folds)} folds, split sizes {counts}")
        # each shift's copies again in process, timed: the same bytes
        for shift in LIDC_SHIFTS:
            files = sorted((data_dir / "preprocessed" / "augmented" / shift / "images").iterdir())
            before = [f.read_bytes() for f in files]
            t0 = time.perf_counter()
            generate_ood_test_files(data_dir, folds[0]["id"], shifts=(shift,), overwrite=True)
            walls[f"{shift}_s"] = time.perf_counter() - t0
            if [f.read_bytes() for f in files] != before:
                raise AssertionError(f"lidc_import: {shift}'s copies differ when made again")
        log(f"lidc_import: the importer {walls['import_s']:.1f}s (process included), splits "
            f"{ {k: len(v) for k, v in folds[0].items() if not k.startswith('_')} }; each "
            f"shift's {counts['id']} copies " + ", ".join(
                f"{s} {walls[f'{s}_s'] * 1e3:.1f} ms" for s in LIDC_SHIFTS))

        # the reference checkpoint, through the reference importer
        ref_ckpt = lidc_reference_checkpoint(tmp / "reference.ckpt", data_dir)
        ckpt = tmp / "imported" / "v0" / "checkpoints" / "last"
        _, walls["convert_s"] = run_module(
            "convert", "diffuncertainty_tpu_torch.tools.import_reference_checkpoint",
            ["--ckpt", str(ref_ckpt), "--out", str(ckpt)])
        state, cfg, meta = load_checkpoint(ckpt)
        want = flax_to_torch(load_params_npz(ASSET))
        for key in ("params", "ema_params"):
            got = flax_to_torch(state[key])
            if got.keys() != want.keys() or not all(torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"lidc_import: the imported {key} differ from the asset")
        asset_cfg = lidc_asset_config(data_dir)
        if (cfg.network.dropout, cfg.data.name, meta["kind"]) != (LIDC_DROPOUT, "lidc128",
                                                                   "imported"):
            raise AssertionError(f"lidc_import: the imported config {cfg.network} {cfg.data}")
        # the reference's hyper_parameters carry no precision: serve in bf16
        config_json = ckpt / "config.json"
        config = json.loads(config_json.read_text())
        config["trainer"]["precision"] = "bf16"
        config_json.write_text(json.dumps(config, indent=2))
        log(f"lidc_import: reference .ckpt ({ref_ckpt.stat().st_size} B) converted in "
            f"{walls['convert_s']:.1f}s (process included); params and ema_params equal the "
            f"asset's {len(want)} tensors bit for bit")

        argv = ["--checkpoint_paths", str(ckpt), "--data_dir", str(data_dir), "--test_split",
                *splits, "--n_pred", "1", "--n_models", str(MEMBERS), "--tta",
                "--test_batch_size", str(BATCH), "--seed", str(seed), "--save_dir",
                str(tmp / "results"), "--include_eval"]
        summaries, walls["job_s"] = run_infer_job("lidc job", argv, timeout=900)
        got_counts = {s["split"]: s["n_images"] for s in summaries}
        if got_counts != counts:
            raise AssertionError(f"lidc job: images per split {got_counts}, expected {counts}")
        walls["job_inference_s"] = sum(s["seconds"] for s in summaries)
        version_dir = Path(summaries[0]["out_dir"]).parent
        decomp = 0.0
        for s in summaries:
            out_dir = Path(s["out_dir"])
            for image_id in json.loads((out_dir / "metrics.json").read_text()):
                tu, au, eu = (read_tiff(out_dir / k / f"{image_id}.tif")
                              for k in ("TU", "AU", "EU"))
                if tu.shape != (HW, HW) or not np.isfinite(tu).all():
                    raise AssertionError(f"lidc job: TU of {image_id} is not a finite map")
                decomp = max(decomp, float(np.abs(tu - au - eu).max()))
        if decomp > 1e-5:
            raise AssertionError(f"lidc job: max |TU - AU - EU| {decomp:.2e} > 1e-5")
        t0 = time.perf_counter()
        aurocs = {}
        for shift in LIDC_SHIFTS:
            res = ood_detection_paired(ResultsReader(version_dir / "id"),
                                       ResultsReader(version_dir / shift),
                                       version_dir / "ood_detection.json",
                                       dataset_key=f"id&{shift}")[f"id&{shift}"]["mean"]
            aurocs[shift] = {unc: res[unc]["image_level"]["metrics"]["auroc"]
                             for unc in ("TU", "EU")}
            for unc, value in aurocs[shift].items():
                if not (math.isfinite(value) and 0.0 <= value <= 1.0):
                    raise AssertionError(f"lidc job: {shift} {unc} AUROC {value}")
        walls["ood_auroc_s"] = time.perf_counter() - t0
        for shift, by_unc in aurocs.items():
            log(f"lidc_import AUROC id vs {shift}, image level: TU {by_unc['TU']:.5f}, "
                f"EU {by_unc['EU']:.5f}")

        # in process: the job's loader on the native reader, one counted batch
        job = UncertaintyInference([ckpt], InferenceConfig(
            n_pred=1, n_models=MEMBERS, tta=True, batch_size=BATCH, seed=seed,
            data_input_dir=str(data_dir), save_dir=str(tmp / "native"), save_outputs=False))
        native_loader.reset_read_count()
        job.run_split("ood_jpeg")
        want_reads = 2 * -(-counts["ood_jpeg"] // BATCH)
        if native_loader.read_count() != want_reads:
            raise AssertionError(f"lidc job: {native_loader.read_count()} native reads, "
                                 f"expected {want_reads} (2 a batch)")
        loader = BatchLoader(job._dataset("id"), BATCH, drop_last=False)
        images = job.normalize(next(iter(loader))["image"])
        # the main path's shapes are checked; check_sites keys a norm site
        # with its members (0: not folded)
        new_attn, new_norm = check_sites(job.sampler, images, attn_checked,
                                         {k + (0,) for k in norm_checked}, seed=900)
        launches, _, images = counted_job_batch("lidc_import path", job, seed, attn_checked,
                                                norm_checked)
        # the job's batch loading, the native reader against the python path:
        # every split's batches, alternated, three rounds, warm file cache
        load_ms, first = {True: [], False: []}, {}
        for _ in range(3):
            for use_native in (True, False):
                t0 = time.perf_counter()
                batches = [b for s in splits for b in BatchLoader(
                    job._dataset(s), BATCH, drop_last=False, use_native=use_native)]
                load_ms[use_native].append((time.perf_counter() - t0) * 1e3 / len(batches))
                first.setdefault(use_native, batches)
        if not all(np.array_equal(a[k], b[k]) for a, b in zip(first[True], first[False])
                   for k in ("image", "seg", "num_raters", "valid")):
            raise AssertionError("lidc_import: the native reader's batches differ from the "
                                 "python path's")
        sampler_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            job._sample_stack(images, torch.Generator("cuda").manual_seed(seed))
            torch.cuda.synchronize()
            sampler_ms.append((time.perf_counter() - t0) * 1e3)
        loading = {"native_ms": load_ms[True], "python_ms": load_ms[False],
                   "sampler_ms": sampler_ms, "batches": len(first[True])}
        log(f"lidc_import batch loading on {smi}, ms a batch over {loading['batches']} batches "
            f"(warm file cache): native {', '.join(f'{v:.3f}' for v in load_ms[True])}; python "
            f"{', '.join(f'{v:.3f}' for v in load_ms[False])}; the sampler call "
            f"{', '.join(f'{v:.2f}' for v in sampler_ms)}; the batches equal")
    # that batch through a sampler built from the asset, same spec and draws
    asset_built = build_model(asset_cfg, device="cuda")
    load_into(asset_built.module, ASSET)
    asset_sampler = make_sampler(asset_built, job.spec)
    maps = [uncertainty_heatmaps(stack.group_means.float(), sample_axis=0, class_axis=-1)
            for stack in (job._sample_stack(images, torch.Generator("cuda").manual_seed(seed)),
                          asset_sampler(images, torch.Generator("cuda").manual_seed(seed)))]
    if not all(torch.equal(maps[0][k], maps[1][k]) for k in ("TU", "AU", "EU")):
        raise AssertionError("lidc_import: the imported checkpoint's heatmaps differ from the "
                             "asset-built sampler's")
    augment = host_augmentations(images[0].float().cpu().numpy())
    img_s = sum(got_counts.values()) / walls["job_inference_s"]
    log(f"lidc_import on {smi}: scans {walls['scans_s']:.1f}s, crops {walls['crops_s']:.1f}s, "
        f"importer {walls['import_s']:.1f}s, conversion {walls['convert_s']:.1f}s, the job "
        f"with --include_eval {walls['job_s']:.1f}s over {sum(got_counts.values())} images "
        f"(inference {walls['job_inference_s']:.1f}s, {img_s:.2f} img/s with writes), OoD "
        f"pairing {walls['ood_auroc_s']:.2f}s; max |TU-AU-EU| {decomp:.2e}; heatmaps equal "
        f"the asset-built sampler's; native reads {want_reads}; new kernel shapes "
        f"{len(new_attn)} / {len(new_norm)}; the host's rater simulators {augment}")
    return launches, {"walls": walls, "img_s": img_s, "images": got_counts, "crops": n_crops,
                      "auroc": aurocs, "loading": loading, "augment_extra": augment}, (
                          new_attn, new_norm)


def host_augmentations(image) -> dict:
    """The host's rater-disagreement simulators and z-score
    (``data/augment_extra.py``, numpy and scipy) once on one image and
    nested labels 1..3 of its size: each output's shape, dtype and labels,
    the share of pixels each deformation moved and its host time."""
    import numpy as np

    from diffuncertainty_tpu_torch.data import augment_extra

    h, w = image.shape[:2]
    yy, xx = np.mgrid[:h, :w]
    r2 = (yy - h / 2) ** 2 + (xx - w / 2) ** 2
    labels = sum(((r2 < (f * min(h, w)) ** 2).astype(np.uint8) for f in (0.35, 0.25, 0.15)),
                 np.zeros((h, w), np.uint8))
    rng = np.random.default_rng(17)
    out, stats = {}, {}
    for name, fn in (
            ("sample_normalize", lambda: augment_extra.sample_normalize(image)),
            ("intensity_guided_sdf_deform",
             lambda: augment_extra.intensity_guided_sdf_deform(image, labels, rng)),
            ("mask_elastic_deform", lambda: augment_extra.mask_elastic_deform(labels, rng))):
        t0 = time.perf_counter()
        out[name] = fn()
        stats[name] = {"ms": (time.perf_counter() - t0) * 1e3}
    z = out.pop("sample_normalize")
    if z.shape != image.shape or abs(float(z.mean())) > 1e-4 or abs(float(z.std()) - 1) > 1e-3:
        raise AssertionError(f"sample_normalize: shape {z.shape}, mean {z.mean()}, std {z.std()}")
    for name, m in out.items():
        if m.shape != labels.shape or m.dtype != labels.dtype or not set(
                np.unique(m).tolist()) <= {0, 1, 2, 3}:
            raise AssertionError(f"{name}: {m.shape} {m.dtype} labels {np.unique(m)}")
        stats[name]["moved"] = float((m != labels).mean())
        if not stats[name]["moved"] > 0:
            raise AssertionError(f"{name} moved no pixel")
    return stats


RETINA_FIXTURES = REPO / "tests" / "fixtures" / "retina_jpeg"
RETINA_JPEGS = ("fundus_420", "fundus_444", "fundus_gray")
RETINA_DISC = (296, 196)  # the fixtures' optic disc, (row, col) (make_fixtures.py)
RETINA_RIGA = (("BinRushed", 2), ("MESSIDOR", 1), ("Magrabi", 1))  # prime TIFFs a clinic
RETINA_REFUGE = (("Training-400", 2), ("Validation-400", 2), ("Test-400", 2))
RETINA_SIZE = 128  # the pipelines' image_size
RETINA_TRAIN = ["data=lidc128", "network=unet16", "model=softmax", "eu_method=dropout",
                "data.num_classes=3", "data.split_name=random", "data.batch_size=4",
                "data.val_batch_size=16", "trainer.max_epochs=2", "trainer.precision=bf16",
                "trainer.loggers=[jsonl]", "seed=3"]


def retina_raw_trees(root: Path, fundus) -> dict:
    """Raw Chaksu, RIGA and REFUGE trees of 512x512 images written by the
    port's own writers (and REFUGE's JPEGs copied from the committed
    fixtures): discs and cups as in ``tests/test_retina.py``, around the
    fixture image's optic disc shifted per sample."""
    import numpy as np

    from diffuncertainty_tpu_torch.data.retina import CIRCLE_WIDTHS
    from diffuncertainty_tpu_torch.infer.image_io import write_png, write_tiff

    rng = np.random.default_rng(19)
    size = fundus.shape[0]
    yy, xx = np.mgrid[:size, :size]

    def disk(cy, cx, r):
        return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r

    def sample(dy, dx):
        img = np.roll(fundus, (dy, dx), axis=(0, 1)).astype(np.int16)
        return np.clip(img + rng.integers(0, 6, img.shape), 0, 255).astype(np.uint8)

    chaksu = root / "chaksu_raw"
    for split, per in (("Train", 3), ("Test", 1)):
        for machine in CIRCLE_WIDTHS:
            for i in range(per):
                dy, dx = (int(v) for v in rng.integers(-20, 21, 2))
                cy, cx = RETINA_DISC[0] + dy, RETINA_DISC[1] + dx
                stem = f"{machine}_{split}_{i}"
                path = chaksu / split / "images" / machine / f"{stem}.png"
                path.parent.mkdir(parents=True, exist_ok=True)
                write_png(path, sample(dy, dx), mode="RGB")
                for k in range(5):
                    for kind, r in (("Disc", 40 + 2 * k), ("Cup", 18 + k % 3)):
                        m = disk(cy, cx, r)
                        m[2:5, 2:5] = True  # a speckle the pipelines drop
                        out = chaksu / split / "labels" / f"Expert{k + 1}" / machine / kind
                        out.mkdir(parents=True, exist_ok=True)
                        write_png(out / f"{stem}.png", m.astype(np.uint8) * 255)
    riga = root / "riga_raw"
    for clinic, n in RETINA_RIGA:
        (riga / clinic).mkdir(parents=True)
        for case in range(1, n + 1):
            dy, dx = (int(v) for v in rng.integers(-20, 21, 2))
            cy, cx = RETINA_DISC[0] + dy, RETINA_DISC[1] + dx
            prime = sample(dy, dx)
            write_tiff(riga / clinic / f"image{case}prime.tif", prime)
            for k in range(1, 7):  # six pencil variants: two rings each
                gt = prime.copy()
                for r in (44 + k, 20 + k % 4):
                    gt[disk(cy, cx, r) & ~disk(cy, cx, r - 3)] = (30, 30, 255)
                write_tiff(riga / clinic / f"image{case}-{k}.tif", gt)
    refuge = root / "refuge_raw"
    n = 0
    for split_dir, count in RETINA_REFUGE:
        for j in range(count):
            stem = f"{split_dir[0]}{j + 1:04d}"
            case = refuge / split_dir / stem
            case.mkdir(parents=True)
            shutil.copy(RETINA_FIXTURES / f"{RETINA_JPEGS[n % 3]}.jpg", case / f"{stem}.jpg")
            n += 1
            for k in range(1, 8):
                write_png(case / f"{stem}_seg_disc_{k}.png",
                          disk(*RETINA_DISC, 40 + k % 5).astype(np.uint8) * 255)
                write_png(case / f"{stem}_seg_cup_{k}.png",
                          disk(*RETINA_DISC, 17 + k % 3).astype(np.uint8) * 255)
    return {"chaksu": chaksu, "riga": riga, "refuge": refuge}


def phase_retina(smi: str, attn_checked: set, norm_checked: set):
    """The retina pipelines on the card's host, without PIL: the committed
    JPEG fixtures decoded and held to Pillow's decode (their ``.npy``);
    synthetic raw Chaksu, RIGA and REFUGE trees through ``python -m
    ...data.retina``'s commands (``clean-riga``, ``chaksu``,
    ``chaksu-splits``, ``riga``, ``refuge``, ``retina-splits``) at
    image_size 128; the combined trees through ``MultiRaterDataset`` and
    ``BatchLoader`` with every rater (5, 6 and 7, padded); a few bf16 steps
    of ``python -m diffuncertainty_tpu_torch.train`` (unet16, softmax with
    MC-dropout, 3 input channels and 3 classes); the job over its
    checkpoint (``python -m ...infer``, ``id_test``) and one batch of it in
    process, its kernel sites checked and its launches counted (11 / 56)."""
    import pickle
    import tempfile

    import numpy as np

    from diffuncertainty_tpu_torch.data import retina
    from diffuncertainty_tpu_torch.data.dataset import MultiRaterDataset
    from diffuncertainty_tpu_torch.data.jpeg_decode import decode_jpeg
    from diffuncertainty_tpu_torch.data.loader import BatchLoader
    from diffuncertainty_tpu_torch.infer.image_io import read_tiff
    from diffuncertainty_tpu_torch.infer.runner import InferenceConfig, UncertaintyInference

    walls, seed = {}, 777
    t0 = time.perf_counter()
    decoded = {}
    for name in RETINA_JPEGS:
        decoded[name] = decode_jpeg(RETINA_FIXTURES / f"{name}.jpg")
        if not np.array_equal(decoded[name], np.load(RETINA_FIXTURES / f"{name}.npy")):
            raise AssertionError(f"retina: {name}.jpg does not decode to Pillow's array")
    walls["decode_s"] = time.perf_counter() - t0
    log(f"retina: the 3 committed JPEGs (4:2:0, 4:4:4, gray; 512x512) decode to Pillow's "
        f"arrays in every pixel ({walls['decode_s']:.2f}s)")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        raw = retina_raw_trees(tmp, decoded["fundus_420"])
        walls["raw_s"] = time.perf_counter() - t0
        parent = tmp / "values_datasets"
        roots = {f"{n}{RETINA_SIZE}": parent / f"{n}{RETINA_SIZE}"
                 for n in ("chaksu", "riga", "refuge")}
        size = ["--image-size", str(RETINA_SIZE)]
        c = raw["chaksu"]
        commands = [
            ["clean-riga", "--input", str(raw["riga"]), "--output", str(tmp / "riga_cleaned")],
            ["chaksu", "--train-image-dir", str(c / "Train" / "images"), "--test-image-dir",
             str(c / "Test" / "images"), "--train-label-dir", str(c / "Train" / "labels"),
             "--test-label-dir", str(c / "Test" / "labels"), "--save-path",
             str(roots["chaksu128"] / "preprocessed"), *size],
            ["chaksu-splits", "--dataset-root", str(roots["chaksu128"]), "--num-splits", "2",
             "--seed", "0"],
            ["riga", "--data-path", str(tmp / "riga_cleaned"), "--save-path",
             str(roots["riga128"] / "preprocessed"), *size],
            ["refuge", "--data-root", str(raw["refuge"]), "--save-path",
             str(roots["refuge128"] / "preprocessed"), *size],
            ["retina-splits", "--roots", *(f"{k}={v}" for k, v in roots.items()), "--output",
             str(parent / "retina128" / "splits" / "random" / "firstCycle"), "--seed", "0"]]
        for argv in commands:
            t0 = time.perf_counter()
            retina.main(argv)
            walls[argv[0]] = time.perf_counter() - t0
        want = {"chaksu128": (12, 5), "riga128": (4, 6), "refuge128": (6, 7)}
        for name, (n_images, n_raters) in want.items():
            pre = roots[name] / "preprocessed"
            images = sorted((pre / "images").glob("*.npy"))
            masks = sorted((pre / "labels").glob("*_mask.npy"))
            if len(images) != n_images or len(masks) != n_images * n_raters:
                raise AssertionError(f"retina: {name} has {len(images)} images and {len(masks)} "
                                     f"masks, expected {n_images} x {n_raters}")
            for path in images[:2] + masks[:2]:
                arr = np.load(path)
                if arr.dtype != np.uint8 or arr.shape[:2] != (RETINA_SIZE, RETINA_SIZE):
                    raise AssertionError(f"retina: {path.name} is {arr.dtype} {arr.shape}")
            labels = np.stack([np.load(p) for p in masks])
            if set(np.unique(labels)) != {0, 1, 2}:
                raise AssertionError(f"retina: {name} labels {np.unique(labels)} != 0, 1, 2")
        folds = pickle.loads((roots["chaksu128"] / "splits" / "scanner" / "firstCycle"
                              / "splits.pkl").read_bytes())
        splits = parent / "retina128" / "splits" / "random" / "firstCycle" / "splits.pkl"
        (fold,) = pickle.loads(splits.read_bytes())
        if (len(folds) != 2 or {k: v["num_raters"] for k, v in
                                fold["_meta"]["dataset_configs"].items()}
                != {k: r for k, (_, r) in want.items()}):
            raise AssertionError(f"retina: splits {len(folds)} folds, {fold['_meta']}")
        # every rater, the rater axis padded to the batch's largest count
        counts = set()
        for split in ("train", "val", "id_test"):
            ds = MultiRaterDataset(splits, parent / "retina128", split=split,
                                   return_all_raters=True)
            for batch in BatchLoader(ds, BATCH, drop_last=False):
                r = batch["num_raters"]
                if batch["seg"].shape[1] != r.max() or any(
                        batch["seg"][i, r[i]:].any() for i in range(len(r))):
                    raise AssertionError(f"retina: {split} rater axis not padded by zeros")
                counts |= set(r[batch["valid"]].tolist())
        if counts != {5, 6, 7}:
            raise AssertionError(f"retina: rater counts {counts} != 5, 6, 7")
        log(f"retina: raw trees in {walls['raw_s']:.1f}s; the pipelines' commands "
            + ", ".join(f"{a[0]} {walls[a[0]]:.2f}s" for a in commands)
            + f"; {sum(n for n, _ in want.values())} samples, batches with 5, 6 and 7 raters")

        # a few bf16 steps through the trainer's entry point, then the job
        t0 = time.perf_counter()
        run_module("retina train", "diffuncertainty_tpu_torch.train", [
            *RETINA_TRAIN, f"data.data_input_dir={parent / 'retina128'}",
            f"save_dir={tmp / 'runs'}"])
        walls["train_s"] = time.perf_counter() - t0
        (ckpt,) = sorted((tmp / "runs").rglob("checkpoints/last"))
        records = [json.loads(line) for line in (ckpt.parents[1] / "metrics.jsonl")
                   .read_text().splitlines()]
        if len(records) != 2 or not all(math.isfinite(r["train_loss"]) for r in records):
            raise AssertionError(f"retina train: records {records}")
        argv = ["--checkpoint_paths", str(ckpt), "--test_split", "id_test", "--n_pred", "1",
                "--n_models", str(MEMBERS), "--tta", "--test_batch_size", str(BATCH),
                "--seed", str(seed), "--save_dir", str(tmp / "results")]
        (summary,), walls["job_s"] = run_infer_job("retina job", argv)
        out_dir = Path(summary["out_dir"])
        metrics = json.loads((out_dir / "metrics.json").read_text())
        if not summary["n_images"] == len(metrics) == len(fold["id_test"]):
            raise AssertionError(f"retina job: {summary} vs {len(fold['id_test'])} images")
        decomp = max(float(np.abs(np.subtract(*(read_tiff(out_dir / k / f"{i}.tif")
                                                for k in ("TU", "AU"))) -
                                  read_tiff(out_dir / "EU" / f"{i}.tif")).max())
                     for i in metrics)
        if decomp > 1e-5:
            raise AssertionError(f"retina job: max |TU - AU - EU| {decomp:.2e}")
        job = UncertaintyInference([ckpt], InferenceConfig(
            n_pred=1, n_models=MEMBERS, tta=True, batch_size=BATCH, seed=seed,
            save_dir=str(tmp / "results")))
        images = job.normalize(next(iter(BatchLoader(job._dataset("id_test"), BATCH,
                                                     drop_last=False)))["image"])
        new_attn, new_norm = check_sites(job.sampler, images, attn_checked,
                                         {k + (0,) for k in norm_checked}, seed=1000)
        launches, _, _ = counted_job_batch("retina path", job, seed, attn_checked,
                                           norm_checked, split="id_test")
    log(f"retina on {smi}: trainer {walls['train_s']:.1f}s, job {walls['job_s']:.1f}s over "
        f"{len(metrics)} images (max |TU-AU-EU| {decomp:.2e}); one job batch: {launches}; "
        f"new kernel shapes {len(new_attn)} / {len(new_norm)}")
    return launches, {"walls": walls, "images": len(metrics),
                      "train_loss": [r["train_loss"] for r in records]}, (new_attn, new_norm)


MULTIDEVICE_TIMEOUT_S = 480
MULTIDEVICE_ENSEMBLE = 4  # members of each deep ensemble the member axis splits
# (checkpoints, InferenceConfig fields, (attention, GroupNorm) launches a rank
# a call): the softmax jobs run 128 rows a rank a call; the prob-U-Net's and
# the HRNet's stacks have no member-folded form, so a rank runs its two
# members one a block (the prob-U-Net twice its one-member 16 / 81)
MULTIDEVICE_JOBS = {
    "job21": ("dropout", dict(n_pred=1, n_models=MEMBERS, mesh_shape=(2, 1)), (11, 56)),
    "job12": ("ensemble", dict(n_pred=4, mesh_shape=(1, 2), member_chunk=1), (11, 56)),
    "prob_unet12": ("prob_unet", dict(n_pred=SAMPLES, mesh_shape=(1, 2), member_chunk=1),
                    tuple(2 * n for n in GENERATIVE16_LAUNCHES["prob_unet"])),
    "hrnet12": ("hrnet", dict(n_pred=4, mesh_shape=(1, 2), member_chunk=1), (0, 0)),
    # at (2, 1) a rank runs all four members, one a block, on its 8 images
    "prob_unet21": ("prob_unet", dict(n_pred=SAMPLES, mesh_shape=(2, 1), member_chunk=1),
                    tuple(4 * n for n in GENERATIVE16_LAUNCHES["prob_unet"])),
    "hrnet21": ("hrnet", dict(n_pred=4, mesh_shape=(2, 1), member_chunk=1), (0, 0)),
}
# the member-sharded stacks with no member-folded form: a rank runs each of
# its members as the single process does (the same rows, weights and
# draws), so the gathered stack equals the single process's bit for bit
MULTIDEVICE_EXACT = ("prob_unet12", "hrnet12")
# the validation beside the loader's: the val split's first 12 images (6 a
# rank) and a tail of its last 4 padded to 5 rows (odd: it runs whole)
VAL_TAIL_ROWS = (12, 5)


def multidevice_inputs(work: Path) -> dict:
    """What both ranks and the single-process reference read: the softmax
    asset as a job checkpoint (MC-dropout), four-member deep ensembles of
    it, of the prob-U-Net asset and of the hrnet-s asset (noise on every
    leaf, seeded), all bf16, the first 16 images of the toy-128 ``id`` split
    and one global training batch. (Seeded random hrnet-s members carry
    logits of hundreds: there a bf16 convolution's batch-dependent rounding
    moves whole pixels, ``tools/layout_probe.py``.)"""
    import numpy as np

    from diffuncertainty_tpu_torch.core.checkpoint import save_checkpoint
    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.core.params import load_into, load_params_npz, torch_to_flax
    from diffuncertainty_tpu_torch.data.loader import BatchLoader
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.train.cli import build_loaders, parse_args

    ckpt, ds = softmax_job_checkpoint(work)
    rng = np.random.default_rng(5)

    def config(network, model):
        return load_config(data="lidc128", network=network, model=model, eu_method="ensemble",
                           precision="bf16", overrides={"data": {
                               "data_input_dir": str(ds.base_dir), "split_name": "default"}})

    def noisy(tree):
        return {k: noisy(v) if isinstance(v, dict) else
                (v * (1 + 0.02 * rng.standard_normal(v.shape))).astype(v.dtype)
                for k, v in tree.items()}

    def ensemble(name, cfg, member_params):
        return [save_checkpoint(work / f"{name}{i}" / "checkpoints" / "last",
                                {"params": member_params(i)}, cfg, epoch=0)
                for i in range(MULTIDEVICE_ENSEMBLE)]

    hrnet_cfg = config("hrnet-s", "softmax")
    hrnet = load_into(build_model(hrnet_cfg, device="cpu").module, ASSET_HRNET)
    hrnet_params = torch_to_flax({k: v.float() for k, v in hrnet.state_dict().items()})

    params, prob_unet = load_params_npz(ASSET), load_params_npz(ASSET_PROB_UNET)
    ens = ensemble("ens", config("unet16", "softmax"), lambda i: noisy(params))
    members = {"prob_unet": ensemble("prob_unet", config("unet16", "prob_unet"),
                                     lambda i: noisy(prob_unet)),
               "hrnet": ensemble("hrnet", hrnet_cfg, lambda i: noisy(hrnet_params))}
    tcfg, _ = parse_args(train_tokens(ds.base_dir, work / "train"))
    batch = next(iter(build_loaders(tcfg)[0]))
    np.savez(work / "train_batch.npz", image=batch["image"], seg=batch["seg"])
    first = next(iter(BatchLoader(ds, BATCH, drop_last=False)))
    return {"dropout": [ckpt], "ensemble": ens, **members, "images": first["image"],
            "train_tokens": train_tokens(ds.base_dir, work / "train")}


def val_tail_batches(cfg) -> list[dict]:
    """The val split as two batches of VAL_TAIL_ROWS: the first splits over
    the data axis, the tail (its last row padding) does not."""
    import numpy as np

    from diffuncertainty_tpu_torch.train.cli import build_loaders

    loader = build_loaders(cfg)[1]
    whole = next(iter(loader))
    n = int(np.sum(whole["valid"]))
    first, tail = VAL_TAIL_ROWS
    if n != first + tail - 1:
        raise AssertionError(f"multidevice: the val split holds {n} images, not "
                             f"{first + tail - 1}")
    keep = {k: v for k, v in whole.items() if isinstance(v, np.ndarray) and len(v) >= n}
    head = {k: v[:first] for k, v in keep.items()}
    pad = {k: np.concatenate([v[first:n], v[first:first + 1]]) for k, v in keep.items()}
    pad["valid"] = np.arange(tail) < tail - 1
    return [head, pad]


def multidevice_rank(work: Path) -> int:
    """One rank of the ``multidevice`` path (``chip_smoke.py
    --multidevice-rank WORKDIR``, started by :func:`phase_multidevice` with
    ``DU_*`` set): each job layout's kernel sites checked against the twins,
    one counted call (its launches), and rank 0 writes the gathered stack's
    heatmaps; then the data-parallel trainer's validation of the asset's
    weights (each val batch sharded over ``data``) and its bf16 step's
    gradients and loss."""
    import numpy as np
    import torch

    from diffuncertainty_tpu_torch.core.params import load_into
    from diffuncertainty_tpu_torch.infer.runner import InferenceConfig, UncertaintyInference
    from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
    from diffuncertainty_tpu_torch.parallel.distributed import initialize_distributed, process_info
    from diffuncertainty_tpu_torch.train.cli import build_loaders, parse_args
    from diffuncertainty_tpu_torch.train.loop import Trainer

    sys.path.insert(0, str(REPO))
    exact_float32()  # as the single process that holds the ranks
    initialize_distributed(device="cuda")
    rank, world = process_info()
    backend = torch.distributed.get_backend()
    inputs = json.loads((work / "inputs.json").read_text())
    report = {"rank": rank, "world": world, "backend": backend, "launches": {}, "ms": {}}
    attn_checked, norm_checked = set(), set()
    for name, (source, fields, (n_attn, n_norm)) in MULTIDEVICE_JOBS.items():
        job = UncertaintyInference([Path(p) for p in inputs[source]], InferenceConfig(
            tta=True, batch_size=BATCH, seed=777, save_dir=str(work / "unused"), **fields))
        images = job.normalize(np.load(work / "images.npy"))
        attn_cases, norm_cases = check_sites(job.sampler, images, attn_checked, norm_checked,
                                             seed=1100)
        report.setdefault("attn_cases", []).extend(attn_cases)
        report.setdefault("norm_cases", []).extend(norm_cases)
        stack, launches, *_ = counted_call(job.built, job._sample_stack, images, 777)
        check_launches(f"multidevice {name} rank {rank}", launches,
                       {"qkv_attention": n_attn, "group_norm_act": n_norm})
        report.setdefault("blocks", {})[name] = job.sampler.blocks
        report["launches"][name] = launches
        report["mesh"] = {**report.get("mesh", {}), name: dict(job.mesh.shape)}
        times = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            job._sample_stack(images, torch.Generator("cuda").manual_seed(i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        report["ms"][name] = times
        if rank == 0:
            maps = uncertainty_heatmaps(stack.group_means.float(), sample_axis=0, class_axis=-1)
            np.savez(work / f"{name}.npz", mean=stack.mean.float().cpu().numpy(),
                     **{k: v.cpu().numpy() for k, v in maps.items()})
        del job, stack
    # one bf16 data-parallel step at (2, 1) from the asset's weights
    cfg, _ = parse_args(inputs["train_tokens"] + ["trainer.mesh_shape=[2,1]"])
    trainer = Trainer(cfg, device="cuda", workdir=work / f"train_rank{rank}")
    load_into(trainer.built.module, ASSET)
    state = trainer.fresh_state()
    report["val"] = trainer.evaluate(state, build_loaders(cfg)[1], epoch=0)
    rows_seen = report["val_tail_rows"] = []
    fns = trainer._eval_loss_fns
    for group, fn in list(fns.items()):
        fns[group] = lambda module, b, *a, _f=fn: rows_seen.append(len(b["image"])) or _f(
            module, b, *a)
    report["val_tail"] = trainer.evaluate(state, val_tail_batches(cfg), epoch=0)
    batch = dict(np.load(work / "train_batch.npz"))
    rows = trainer.mesh.rows(batch["image"].shape[0], "data")
    local = {k: v[rows] for k, v in batch.items()}
    aux, grads = trainer.step_gradients(state, local, torch.Generator("cuda").manual_seed(7))
    report["step_loss"] = float(aux["loss"])
    state, aux = trainer.train_step(state, local, torch.Generator("cuda").manual_seed(7))
    report["step_finite"] = all(bool(torch.isfinite(p).all()) for p in state.params.values())
    if rank == 0:
        np.savez(work / "grads.npz", **{k: g.float().cpu().numpy()
                                        for k, g in zip(state.params, grads)})
    (work / f"rank{rank}.json").write_text(json.dumps(report))
    torch.distributed.destroy_process_group()
    return 0


def phase_multidevice(smi: str, attn_checked: set, norm_checked: set):
    """Two ranks on the one card (``DU_COORDINATOR``, ``DU_NUM_PROCESSES``,
    ``DU_PROCESS_ID`` and ``DU_DIST_BACKEND=gloo`` on CUDA tensors: NCCL
    refuses two ranks on one device), each a ``chip_smoke.py
    --multidevice-rank`` process with this process's float32 settings
    (``exact_float32``): the job at mesh (2, 1) (the MC-dropout asset, 16
    members x TTA) and (1, 2) (a four-member ensemble of it, two a rank in
    one block although ``member_chunk=1``; four-member prob-U-Net (the
    asset's widths, 16 latent draws) and hrnet-s (x TTA) ensembles, two a
    rank one at a time, and the same two at (2, 1), all four a rank on its
    8 images) on the toy-128 16-image batch, each rank's calls counted (11 /
    56, 32 / 162 and 64 / 324, 0 / 0), and the data-parallel trainer at (2,
    1): its validation, the same with a tail that runs whole
    (VAL_TAIL_ROWS), and one bf16 step; held against this process's
    single-process jobs, validation and step on the same seed (heatmaps and
    mean to the port's bf16 call tolerance, and the member-sharded unfolded
    stacks MULTIDEVICE_EXACT bit for bit; every validation number to the
    step's loss tolerance, each gradient leaf to STEP_GRAD_TOL); then a
    world-size-1 NCCL group through ``initialize_distributed``."""
    import os
    import socket
    import tempfile

    import numpy as np
    import torch

    from diffuncertainty_tpu_torch.infer.runner import InferenceConfig, UncertaintyInference
    from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
    from diffuncertainty_tpu_torch.parallel.distributed import initialize_distributed
    from diffuncertainty_tpu_torch.core.params import load_into
    from diffuncertainty_tpu_torch.train.cli import build_loaders, parse_args
    from diffuncertainty_tpu_torch.train.loop import Trainer

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        inputs = multidevice_inputs(work)
        np.save(work / "images.npy", inputs.pop("images"))
        (work / "inputs.json").write_text(json.dumps(
            {k: [str(p) for p in v] if k != "train_tokens" else v for k, v in inputs.items()}))
        env = {**os.environ, "DU_COORDINATOR": f"localhost:{free_port()}",
               "DU_NUM_PROCESSES": "2", "DU_DIST_BACKEND": "gloo"}
        t0 = time.perf_counter()
        procs = []
        for r in range(2):
            with open(work / f"rank{r}.log", "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--multidevice-rank",
                     str(work)], cwd=REPO, env={**env, "DU_PROCESS_ID": str(r)}, stdout=fh,
                    stderr=subprocess.STDOUT))
        try:
            for p in procs:
                p.wait(timeout=max(1.0, MULTIDEVICE_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out["ranks_s"] = time.perf_counter() - t0
        logs = [(work / f"rank{r}.log").read_text() for r in range(2)]
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"multidevice: rank {r} exited {p.returncode}:\n"
                                     f"{logs[r][-4000:]}")
        reports = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
        for r, rep in enumerate(reports):
            log(f"multidevice rank {r} ({rep['backend']}, world {rep['world']}): launches a "
                f"call {rep['launches']}, ms a call {rep['ms']}, mesh {rep['mesh']}, blocks "
                f"{rep['blocks']}")
        # the single-process jobs, validation and step, same seeds
        images = np.load(work / "images.npy")
        refs = {}  # one single-process job per (source, n_pred): the layouts share it
        for name, (source, fields, _) in MULTIDEVICE_JOBS.items():
            key = (source, fields["n_pred"])
            if key not in refs:
                job = UncertaintyInference(inputs[source], InferenceConfig(
                    tta=True, batch_size=BATCH, seed=777, save_dir=str(work / "unused"),
                    **{**fields, "mesh_shape": None, "member_chunk": None}))
                x = job.normalize(images)
                cases = check_sites(job.sampler, x, attn_checked,
                                    {k + (0,) for k in norm_checked}, seed=1200)
                out.setdefault("attn_cases", []).extend(cases[0])
                out.setdefault("norm_cases", []).extend(cases[1])
                stack = job._sample_stack(x, torch.Generator("cuda").manual_seed(777))
                refs[key] = {k: v.cpu().numpy() for k, v in uncertainty_heatmaps(
                    stack.group_means.float(), sample_axis=0, class_axis=-1).items()}
                refs[key]["mean"] = stack.mean.float().cpu().numpy()
                del job, stack
            ref = refs[key]
            got = dict(np.load(work / f"{name}.npz"))
            diffs = {k: float(np.abs(got[k] - ref[k]).mean()) for k in ref}
            agree = float((got["mean"].argmax(-1) == ref["mean"].argmax(-1)).mean())
            log(f"multidevice {name} vs one process, same seed: mean |d| {diffs}, argmax "
                f"agreement {agree:.5f}")
            if max(diffs.values()) > TWIN_CALL_TOL[0] or agree < TWIN_CALL_TOL[1]:
                raise AssertionError(f"multidevice {name} differs from the single-process job")
            if name in MULTIDEVICE_EXACT and (max(diffs.values()) > 0 or agree < 1):
                raise AssertionError(f"multidevice {name}: a member-sharded stack with no "
                                     f"folded form differs from the single process's")
            out[name] = {"mean_abs_diff": diffs, "argmax_agreement": agree}
        cfg, _ = parse_args(inputs["train_tokens"])
        trainer = Trainer(cfg, device="cuda", workdir=work / "train_single")
        load_into(trainer.built.module, ASSET)
        state = trainer.fresh_state()
        val = trainer.evaluate(state, build_loaders(cfg)[1], epoch=0)
        val_ranks = [rep["val"] for rep in reports]
        log(f"multidevice validation at (2, 1) vs one process: {val_ranks} vs {val}")
        if (val_ranks[0] != val_ranks[1] or set(val_ranks[0]) != set(val)
                or any(abs(val_ranks[0][k] - v) > 1e-2 * abs(v) for k, v in val.items())):
            raise AssertionError("multidevice: the data-parallel validation differs from the "
                                 "single-process validation")
        out["validation"] = {"single": val, "ranks": val_ranks[0]}
        tail = trainer.evaluate(state, val_tail_batches(cfg), epoch=0)
        tails = [rep["val_tail"] for rep in reports]
        rows = [rep["val_tail_rows"] for rep in reports]
        log(f"multidevice validation with a whole tail at (2, 1) vs one process: {tails} vs "
            f"{tail}; rows a rank's loss saw {rows}")
        if (tails[0] != tails[1] or set(tails[0]) != set(tail)
                or rows != [[VAL_TAIL_ROWS[0] // 2, VAL_TAIL_ROWS[1]]] * 2
                or any(abs(tails[0][k] - v) > 1e-2 * abs(v) for k, v in tail.items())):
            raise AssertionError("multidevice: the data-parallel validation with a whole tail "
                                 "differs from the single-process validation")
        out["validation_tail"] = {"single": tail, "ranks": tails[0], "rows": rows[0]}
        batch = dict(np.load(work / "train_batch.npz"))
        aux, grads = trainer.step_gradients(state, batch, torch.Generator("cuda").manual_seed(7))
        null = null_gradient_leaves(trainer, state, batch)
        got = np.load(work / "grads.npz")
        rel = {n: float(np.linalg.norm(got[n] - g.float().cpu().numpy())
                        / np.linalg.norm(g.float().cpu().numpy()))
               for n, g in zip(state.params, grads) if n not in null}
        worst = max(rel, key=rel.get)
        loss = float(aux["loss"])
        losses = [rep["step_loss"] for rep in reports]
        log(f"multidevice step at (2, 1) vs one process: loss {losses} vs {loss:.6f}; gradient "
            f"rel L2 per leaf max {rel[worst]:.3e} at {worst}, median "
            f"{statistics.median(rel.values()):.3e} over {len(rel)} leaves ({len(null)} "
            f"zero-gradient leaves left out)")
        if (rel[worst] > STEP_GRAD_TOL or abs(losses[0] - loss) > 1e-2 * abs(loss)
                or losses[0] != losses[1] or not all(rep["step_finite"] for rep in reports)):
            raise AssertionError("multidevice: the data-parallel step differs from the "
                                 "single-process step")
        out["step"] = {"max_rel": rel[worst], "loss": loss, "losses": losses}
    # a world of one on NCCL, through the entry point's initializer
    initialize_distributed(f"localhost:{free_port()}", 1, 0, device="cuda")
    try:
        backend = torch.distributed.get_backend()
        x = torch.ones(4, device="cuda")
        torch.distributed.all_reduce(x)
        if backend != "nccl" or x.tolist() != [1.0] * 4:
            raise AssertionError(f"multidevice: world of one on {backend}: {x.tolist()}")
    finally:
        torch.distributed.destroy_process_group()
    log(f"multidevice on {smi}: ranks {out['ranks_s']:.1f}s; a world of one on nccl all-reduces")
    launches = {f"multidevice_{name}_rank{rep['rank']}": rep["launches"][name]
                for rep in reports for name in MULTIDEVICE_JOBS}
    for rep in reports:
        out["attn_cases"] = out.get("attn_cases", []) + rep.get("attn_cases", [])
        out["norm_cases"] = out.get("norm_cases", []) + rep.get("norm_cases", [])
    return launches, out


def train_tokens(data_dir, save_dir) -> list[str]:
    """The command line of the JAX recipe's first member
    (``tools/train_recipe.py::recipe_tokens``)."""
    from diffuncertainty_tpu_torch.tools.train_recipe import recipe_tokens

    return recipe_tokens(data_dir, save_dir, seed=TRAIN_SEED, epochs=TRAIN_EPOCHS, hw=HW)


def grad_error(name: str, got, ref) -> dict:
    """``got`` (the kernel's gradient) against ``ref`` (fp32 autograd of the
    twin, or the kernel's plain version) under GRAD_TOL; the max abs and the
    max abs over max |ref|."""
    import torch

    a, r = GRAD_TOL
    ref = ref.float()
    err = (got.float() - ref).abs()
    scale = ref.abs().max().item()
    bad = (err > a * scale + r * ref.abs()).sum().item()
    out = {"max_abs_err": err.max().item(), "max_rel_err": err.max().item() / max(scale, 1e-30)}
    if not torch.isfinite(got.float()).all() or bad:
        raise AssertionError(f"{name}: the backward kernel disagrees with its reference: {bad} "
                             f"elements beyond {a}*max|ref| + {r}*|ref| ({out})")
    return out


def attention_backward_case(b: int, t: int, c: int, calls: int, seed: int) -> dict:
    """The attention backward kernel at (b, t, 3c): the forward under grad
    (writing m and l) equal bit for bit to the no-grad forward; the
    Function's gradient (kernel forward, backward kernel) against fp32
    autograd of the twin and against the kernel's plain version on the card,
    both under GRAD_TOL; two kernel calls bit-equal; the kernel's time beside
    the twin VJP's, the plain version's, SDPA's backward and the bound (CUDA
    events, median of 10), and its device time and device kernels a call
    (``groupnorm_sites.call_kernels``, 10 calls)."""
    import torch
    import torch.nn.functional as F

    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import (attention_backward_bound,
                                                                 call_kernels, event_ms, fmt)

    gen = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    g_out = torch.randn((b, t, c), generator=gen, device="cuda").to(torch.bfloat16)
    site = f"attention backward B={b} T={t} C={c}"
    with torch.no_grad():
        out0 = ca.qkv_attention_cuda(qkv, 4)
    out, m, lsum = ca._forward(qkv, 4, stats=True)
    if not torch.equal(out, out0):
        raise AssertionError(f"{site}: the forward under grad differs from the no-grad forward")
    x = qkv.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(ca.qkv_attention_cuda(x, 4), x, g_out)
    again = ca._backward(qkv, out, m, lsum, g_out, 4)
    if not (torch.equal(got, again) and torch.equal(again, ca._backward(qkv, out, m, lsum,
                                                                         g_out, 4))):
        raise AssertionError(f"{site}: two calls of the backward kernel differ")
    x32 = qkv.float().requires_grad_(True)
    (ref,) = torch.autograd.grad(ca.qkv_attention_reference(x32, 4), x32, g_out.float())
    plain = ca.qkv_attention_backward_reference(qkv, out, m, lsum, g_out, 4)
    case = {"B": b, "T": t, "C": c, "d": c // 4, "calls": calls,
            **grad_error(site, got, ref),
            "max_abs_err_plain": grad_error(f"{site} vs its plain version", got,
                                            plain)["max_abs_err"]}
    case["ms"] = event_ms(lambda: ca._backward(qkv, out, m, lsum, g_out, 4), runs=10)
    case["device_ms"], case["device_kernels"] = call_kernels(
        lambda: ca._backward(qkv, out, m, lsum, g_out, 4), n=10)
    case["vjp_ms"] = event_ms(lambda: ca.qkv_attention_vjp(qkv, 4, g_out), runs=10)
    case["plain_ms"] = event_ms(lambda: ca.qkv_attention_backward_reference(
        qkv, out, m, lsum, g_out, 4), runs=10)
    ch = c // 4
    qh = qkv.view(b, t, 4, 3 * ch).permute(0, 2, 1, 3)
    q, k, v = (qh[..., j * ch:(j + 1) * ch].contiguous().requires_grad_(True) for j in range(3))
    o = F.scaled_dot_product_attention(q, k, v, scale=ch ** -0.5)
    g4 = g_out.view(b, t, 4, ch).permute(0, 2, 1, 3)
    case["library_ms"] = event_ms(lambda: torch.autograd.grad(o, (q, k, v), g4,
                                                              retain_graph=True), runs=10)
    case["bound_ms"], case["bound_by"] = attention_backward_bound(b, t, c, 4)
    log(f"{site}: max|g-g32| {case['max_abs_err']:.3e} ({case['max_rel_err']:.3e} of max|g32|), "
        f"max|g-plain| {case['max_abs_err_plain']:.3e}, repeat bit-equal, forward under grad "
        f"bit-equal; kernel {case['ms']:.4f} ms (device {fmt(case['device_ms'])} in "
        f"{case['device_kernels']} device kernels), twin VJP {case['vjp_ms']:.4f} ms, plain "
        f"{case['plain_ms']:.4f} ms, sdpa backward {case['library_ms']:.4f} ms, bound "
        f"{case['bound_ms']:.4f} ms ({case['bound_by']})")
    return case


def norm_backward_case(shape: tuple, dt: str, act: str, calls: int, seed: int,
                       members: int = 0, timed: bool = True) -> dict:
    """The GroupNorm backward kernel at ``shape`` (with an ``(members, C)``
    affine when ``members`` > 0), checked as :func:`attention_backward_case`
    (its three gradients each under GRAD_TOL); one device kernel a call
    (``groupnorm_sites.call_kernels``: the trace of 10 calls, or of 5 when
    not ``timed``, shows one device activity in each, and its device time);
    timed beside the twin VJP, the plain version, ``F.group_norm`` (+
    ``F.silu``) backward and the bound unless ``timed`` is off."""
    import torch
    import torch.nn.functional as F

    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
    from diffuncertainty_tpu_torch.ops.norm import num_groups_for
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import (call_kernels, event_ms, fmt,
                                                                 norm_backward_bound)

    dtype = getattr(torch, dt)
    c = shape[-1]
    gen = torch.Generator("cuda").manual_seed(seed)
    x = (3.0 * torch.randn(shape, generator=gen, device="cuda") + 1.0).to(dtype)
    lead = (members,) if members else ()
    scale = torch.randn(lead + (c,), generator=gen, device="cuda")
    bias = torch.randn(lead + (c,), generator=gen, device="cuda")
    gy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    site = f"GroupNorm backward {shape} {dt} {act}" + (f" ({members}, {c}) affine"
                                                        if members else "")
    with torch.no_grad():
        y0 = gn.group_norm_act(x, scale, bias, act)
    y, mean, var = gn._forward(x, scale, bias, act, 1e-5, None, stats=True)
    if not torch.equal(y, y0):
        raise AssertionError(f"{site}: the forward under grad differs from the no-grad forward")
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    got = torch.autograd.grad(gn.group_norm_act(*leaves, act), leaves, gy)
    for _ in range(2):
        again = gn._backward(x, scale, bias, mean, var, gy, act, 1e-5)
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            raise AssertionError(f"{site}: two calls of the backward kernel differ")
    leaves32 = [t.float().requires_grad_(True) for t in (x, scale, bias)]
    ref = torch.autograd.grad(gn.group_norm_act_reference(*leaves32, act), leaves32, gy.float())
    plain = gn.group_norm_act_backward_reference(x, scale, bias, mean, var, gy, act)
    errs = [grad_error(f"{site} d{w}", g, r) for w, g, r in zip(("x", "scale", "bias"), got, ref)]
    plain_errs = [grad_error(f"{site} d{w} vs its plain version", g, r)
                  for w, g, r in zip(("x", "scale", "bias"), got, plain)]
    s = x.numel() // (shape[0] * c)
    plan = gn.backward_plan(s, c, dtype, shape[0])
    call = lambda: gn._backward(x, scale, bias, mean, var, gy, act, 1e-5)  # noqa: E731
    dev, kernels = call_kernels(call, n=10 if timed else 5)
    if kernels != 1:
        raise AssertionError(f"{site}: {kernels} device activities a call in the profiler's "
                             f"trace, not the one backward kernel")
    case = {"shape": list(shape), "dtype": dt, "act": act, "members": members, "calls": calls,
            "max_abs_err": max(e["max_abs_err"] for e in errs),
            "max_rel_err": max(e["max_rel_err"] for e in errs),
            "max_abs_err_plain": max(e["max_abs_err"] for e in plain_errs),
            "cluster": plan.cluster, "threads": plan.threads, "slice_pix": plan.slice_pix,
            "cache_pix": plan.cache_pix, "mode": plan.mode, "smem": plan.smem,
            "device_ms": dev, "device_kernels": kernels,
            "max_active_clusters": gn.max_active_clusters(s, c, dtype, act, plan, x.device,
                                                          backward=True)}
    text = (f"{site}: max|g-g32| {case['max_abs_err']:.3e} ({case['max_rel_err']:.3e} of "
            f"max|g32|), max|g-plain| {case['max_abs_err_plain']:.3e}, repeat bit-equal, forward "
            f"under grad bit-equal; K={plan.cluster} {plan.mode} ({plan.cache_pix} of "
            f"{plan.slice_pix} pixels cached, {plan.smem} B), {plan.threads} threads, "
            f"{case['max_active_clusters']} clusters at once; one device kernel a call, device "
            f"{fmt(dev)}")
    if not timed:
        log(text)
        return case
    case["ms"] = event_ms(call, runs=10)
    case["vjp_ms"] = event_ms(lambda: gn.group_norm_act_vjp(x, scale, bias, act, 1e-5, gy),
                              runs=10)
    case["plain_ms"] = event_ms(lambda: gn.group_norm_act_backward_reference(
        x, scale, bias, mean, var, gy, act), runs=10)
    xv = x.movedim(-1, 1).detach().requires_grad_(True)
    sc, bi = scale.to(dtype).requires_grad_(True), bias.to(dtype).requires_grad_(True)
    yl = F.group_norm(xv, num_groups_for(c), sc, bi, 1e-5)
    yl = F.silu(yl) if act == "silu" else yl
    case["library_ms"] = event_ms(lambda: torch.autograd.grad(
        yl, (xv, sc, bi), gy.movedim(-1, 1), retain_graph=True), runs=10)
    case["bound_ms"], case["bound_by"] = norm_backward_bound(shape, x.element_size(), act,
                                                             scale.numel())
    log(f"{text}; kernel {case['ms']:.4f} ms, twin VJP {case['vjp_ms']:.4f} ms, plain "
        f"{case['plain_ms']:.4f} ms, F.group_norm backward {case['library_ms']:.4f} ms, bound "
        f"{case['bound_ms']:.4f} ms ({case['bound_by']})")
    return case


def vjp_cases(norm_site_list, attn_sites=None) -> tuple[list[dict], list[dict]]:
    """Each backward kernel at the training step's shapes (batch 16):
    :func:`attention_backward_case` at every attention site and
    :func:`norm_backward_case` at every GroupNorm site with silu and with
    none. ``attn_sites``: {T: (calls, C)} of one training forward (unet16's
    by default); ``norm_site_list``: its GroupNorm sites (shape without the
    batch, dtype, act)."""
    import torch

    attn = [attention_backward_case(BATCH, t, c, calls, 900 + i)
            for i, (t, (calls, c)) in enumerate((attn_sites or UNET16_ATTENTION).items())]
    calls = {}
    for shape, dt, act in norm_site_list:
        calls[(shape, dt)] = calls.get((shape, dt), 0) + 1
    norms = []
    for i, ((shape, dt), _) in enumerate(sorted(calls.items(), key=lambda kv: (-kv[0][0][0],
                                                                              kv[0]))):
        for act in ("silu", "none"):
            n = sum(1 for site in norm_site_list if site == (shape, dt, act))
            norms.append(norm_backward_case((BATCH,) + shape, dt, act, n,
                                            950 + 2 * i + (act == "none")))
    torch.cuda.empty_cache()
    return attn, norms


@contextlib.contextmanager
def twins_forced():
    """Both kernels' call sites in the network take the plain twins (plain
    autograd, no Function) while the block runs."""
    from diffuncertainty_tpu_torch.models import unet
    from diffuncertainty_tpu_torch.ops import attention
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn

    saved = attention.qkv_attention_cuda, unet.group_norm_act
    attention.qkv_attention_cuda = ca.qkv_attention_reference
    unet.group_norm_act = gn.group_norm_act_reference
    try:
        yield
    finally:
        attention.qkv_attention_cuda, unet.group_norm_act = saved


def null_gradient_leaves(trainer, state, batch) -> set[str]:
    """The parameters whose exact gradient is 0 on this batch: the same step
    in float64 (a copy of the network, both twins) gives them less than 1e-8
    of the largest leaf's gradient norm. These are biases that reach the
    loss only through a GroupNorm of one channel per group, which removes
    them (a ResBlock's ``in_conv`` bias at 32 channels, the last block's
    ``out_conv`` and ``skip_conv`` biases before the head's norm), and the
    prob-U-Net base's output head, which the fcomb's decode replaces."""
    import copy

    import torch

    from diffuncertainty_tpu_torch.data.augment import augment_batch

    module = copy.deepcopy(trainer.built.module).double()
    for m in module.modules():  # every DiffUnet of the family computes in float64
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    gen = torch.Generator("cuda").manual_seed(7)
    images = torch.as_tensor(batch["image"]).to("cuda", torch.float64)
    seg = torch.as_tensor(batch["seg"]).to("cuda")
    images, seg = augment_batch(trainer.aug_cfg, gen, images, seg)
    with twins_forced():
        loss, _ = trainer.loss_fn(module, {"image": images, "seg": seg}, gen, trainer.sched)
        grads = torch.autograd.grad(loss, list(module.parameters()), allow_unused=True)
    norms = {n: 0.0 if g is None else g.norm().item()
             for (n, _), g in zip(module.named_parameters(), grads)}
    assert list(norms) == list(state.params)
    top = max(norms.values())
    return {n for n, v in norms.items() if v < 1e-8 * top}


def step_counts() -> dict:
    """Both kernels' forward and backward launches and their twins' VJPs."""
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn

    return {"qkv_attention": ca.launch_count(), "group_norm_act": gn.launch_count(),
            "qkv_attention_bwd": ca.backward_launch_count(),
            "group_norm_act_bwd": gn.backward_launch_count(),
            "qkv_attention_vjp": ca.vjp_count(), "group_norm_act_vjp": gn.vjp_count()}


def want_counts(launches: tuple, backward: tuple | None = None) -> dict:
    """The counts of a training step: ``launches`` forward launches
    (attention, GroupNorm), ``backward`` backward launches (the forward's by
    default), no twin VJP."""
    backward = backward or launches
    return {"qkv_attention": launches[0], "group_norm_act": launches[1],
            "qkv_attention_bwd": backward[0], "group_norm_act_bwd": backward[1],
            "qkv_attention_vjp": 0, "group_norm_act_vjp": 0}


def phase_train_step(smi: str, trainer, batches, attn_checked: set, norm_checked: set,
                     want: tuple = (11, 56), want_bwd: tuple | None = None,
                     label: str = "train step", runs: int = 10,
                     compare_twins: bool = True) -> dict:
    """One full-model bf16 step at batch 16: launches (``want``: attention,
    GroupNorm), backward launches (``want_bwd``, the launches by default)
    and twin VJPs (none) counted,
    every leaf's gradient against the twins-forced step (unless
    ``compare_twins`` is off: a network without the kernels), and the step's
    split (median of ``runs`` steps after 2) and busy share (over
    ``PROFILED_STEPS`` steps)."""
    import torch

    from diffuncertainty_tpu_torch.models.unet import AttentionBlock, GroupNorm32
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
    from diffuncertainty_tpu_torch.tools.profile_main_path import device_ms

    # from the flax init, the zero head conv stops every gradient but its own
    # at step 0, and the zero ResBlock out_convs stop the blocks' inner
    # gradients at step 1: the counted step is step 2
    state = trainer.init_state()
    for i in range(2):
        state, _ = trainer.train_step(state, batches[i], trainer.epoch_generator(0))
    module = trainer.built.module

    def grads(seed):
        loss, _ = trainer.forward_loss(batches[1], torch.Generator("cuda").manual_seed(seed))
        return loss, trainer.gradients(state, loss)

    attn_seen, norm_seen = [], []
    hooks = [m.register_forward_pre_hook(
        (lambda mod, args: attn_seen.append(tuple(args[0].shape))) if isinstance(m, AttentionBlock)
        else (lambda mod, args: norm_seen.append(
            (tuple(args[0].shape), str(args[0].dtype).split(".")[-1], mod.act))))
        for m in module.modules() if isinstance(m, (AttentionBlock, GroupNorm32))]
    torch.cuda.synchronize()
    with counting_twins() as twins:
        ca.reset_launch_count()
        gn.reset_launch_count()
        loss, g = grads(7)
        torch.cuda.synchronize()
        counts = step_counts()
    for h in hooks:
        h.remove()
    want = want_counts(want, want_bwd)
    log(f"{label}: launches, backward launches and twin VJPs {counts} (expected {want}), twin "
        f"forwards {twins}")
    if counts != want or any(twins.values()):
        raise AssertionError(f"{label}: {counts} != {want} or twin forwards ran: {twins}")
    shapes = {(b, hh * ww, c) for b, hh, ww, c in attn_seen}
    if not shapes <= attn_checked or not set(norm_seen) <= norm_checked:
        raise AssertionError(f"{label}: unchecked attention shapes {shapes - attn_checked} or "
                             f"norm sites {set(norm_seen) - norm_checked}")
    rel, worst = {None: 0.0}, None
    if compare_twins:
        names = list(state.params)
        null = null_gradient_leaves(trainer, state, batches[1])
        for name, gi in zip(names, g):
            if not torch.isfinite(gi).all() or not (name in null or gi.abs().max().item() > 0):
                raise AssertionError(f"{label}: the gradient of {name} is not finite or is 0")
        with twins_forced():
            loss_t, g_t = grads(7)
        rel = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
               for n, a, b in zip(names, g, g_t) if n not in null}
        worst = max(rel, key=rel.get)
        log(f"{label}: loss {loss.item():.6f} (twins forced {loss_t.item():.6f}); gradient rel "
            f"L2 error per leaf through the kernels vs twins forced: max {rel[worst]:.3e} at "
            f"{worst}, median {statistics.median(rel.values()):.3e} over {len(rel)} leaves "
            f"({len(null)} zero-gradient leaves left out: {sorted(null)})")
        if rel[worst] > STEP_GRAD_TOL:
            raise AssertionError(f"{label}: {worst} gradient rel error {rel[worst]:.3e} > "
                                 f"{STEP_GRAD_TOL}")
        del g_t, loss_t

    # the step's split (CUDA events, median of 10): forward (augment, forward,
    # loss), backward with the two backward kernels' calls apart, optimizer + EMA
    bwd_events = {"qkv_attention": [], "group_norm_act": []}

    def timed(mod, name, kernel):
        fn = getattr(mod, name)

        def wrapper(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            bwd_events[kernel].append((start, end))
            return out
        return fn, wrapper

    split = {"forward": [], "backward": [], "optimizer_ema": [],
             "attention_backward": [], "group_norm_backward": []}
    saved = [(ca, "_backward", "qkv_attention"), (gn, "_backward", "group_norm_act")]
    originals = []
    for mod, name, kernel in saved:
        fn, wrapper = timed(mod, name, kernel)
        originals.append(fn)
        setattr(mod, name, wrapper)
    try:
        for i in range(runs + 2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            for v in bwd_events.values():
                v.clear()
            ev[0].record()
            loss, _ = trainer.forward_loss(batches[i % 2], torch.Generator("cuda").manual_seed(i))
            ev[1].record()
            g = trainer.gradients(state, loss)
            ev[2].record()
            state, _ = trainer.apply_gradients(state, g)
            ev[3].record()
            torch.cuda.synchronize()
            if i >= 2:
                split["forward"].append(ev[0].elapsed_time(ev[1]))
                split["backward"].append(ev[1].elapsed_time(ev[2]))
                split["optimizer_ema"].append(ev[2].elapsed_time(ev[3]))
                split["attention_backward"].append(sum(s.elapsed_time(e)
                                                       for s, e in bwd_events["qkv_attention"]))
                split["group_norm_backward"].append(sum(s.elapsed_time(e)
                                                        for s, e in bwd_events["group_norm_act"]))
    finally:
        for (mod, name, _), fn in zip(saved, originals):
            setattr(mod, name, fn)
    split = {k: statistics.median(v) for k, v in split.items()}
    # device busy share and peak memory over PROFILED_STEPS plain steps
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gen = torch.Generator("cuda").manual_seed(1)
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for i in range(PROFILED_STEPS):
            state, _ = trainer.train_step(state, batches[i % 2], gen)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / PROFILED_STEPS
    dev = device_ms(prof, PROFILED_STEPS)
    busy = dev["busy"]
    split.update(step_wall_ms=wall, device_ms=busy, device_sum_ms=dev["sum"],
                 busy_share=busy / wall if busy > 0 else None,
                 peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"{label} split on {smi} (batch {BATCH}, CUDA events, median of {runs}): forward "
        f"{split['forward']:.2f} ms, backward {split['backward']:.2f} ms (of which the "
        f"attention backward kernels' calls {split['attention_backward']:.2f} ms and the "
        f"GroupNorm backward kernels' calls {split['group_norm_backward']:.2f} ms), optimizer + EMA {split['optimizer_ema']:.2f} ms; "
        f"{PROFILED_STEPS} steps: {wall:.2f} ms a step, device {busy:.2f} ms (kernel times summed "
        f"{dev['sum']:.2f} ms, {dev['streams']} streams), busy share "
        + ("not measured" if split["busy_share"] is None else f"{split['busy_share']:.3f}")
        + f", peak memory {split['peak_memory_gib']:.2f} GiB")
    return {"launches": counts, "max_leaf_rel_err": rel[worst], "split": split}


def phase_train(smi: str, norm_site_list, runs) -> Generator[None, None, dict]:
    """The trainer: each kernel's backward at the training shapes, one
    counted full-model step and the remat step, then the recipe through the
    user's entry point (an entry-point run), the quality of its EMA weights,
    and the inference job on its checkpoint."""
    import ast

    import numpy as np
    import torch

    from diffuncertainty_tpu_torch.core.checkpoint import load_checkpoint
    from diffuncertainty_tpu_torch.core.config import apply_overrides
    from diffuncertainty_tpu_torch.core.params import flax_to_torch
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.sampling.sampler import SamplerSpec, make_sampler
    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset, toy128_quality_eval
    from diffuncertainty_tpu_torch.train.cli import build_loaders, parse_args
    from diffuncertainty_tpu_torch.train.loop import Trainer

    attn_cases, norm_cases, attn_checked, norm_checked = unet16_train_checks(norm_site_list)
    data_dir = toy128_dataset(HW).base_dir
    out = {"attention_backward": attn_cases, "group_norm_backward": norm_cases}
    tmp = runs.dir("train")
    cfg, _ = parse_args(train_tokens(data_dir, tmp))
    trainer = Trainer(cfg, device="cuda", workdir=runs.dir("train_probe"))
    train_loader, _, _ = build_loaders(cfg)
    batches = list(train_loader)[:2]
    out["step"] = phase_train_step(smi, trainer, batches, attn_checked, norm_checked)
    del trainer
    torch.cuda.empty_cache()
    out["remat"] = phase_remat_step(smi, apply_overrides(cfg, [
        f"save_dir={runs.dir('train_remat')}"]), batches)
    del batches
    torch.cuda.empty_cache()
    yield  # the rest is not timed: it waits for the entry-point run

    wall, text = run_output(runs, "train")
    (steps_line,) = [ln for ln in text.splitlines() if ln.startswith("steps ")]
    workdir = Path(tmp) / cfg.auto_exp_name / "version_0"
    records = [json.loads(ln) for ln in (workdir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    tail = float(np.mean(losses[-10:]))
    log(f"train recipe: exit 0 in {wall:.1f}s (process included, {BESIDE}) on "
        f"{smi}: {steps_line}; "
        f"{len(losses)} epochs, train_loss epoch 0 {losses[0]:.4f}, mean of the last 10 "
        f"{tail:.4f}; validation {[r for r in records if 'val_dice' in r][-1:]}")
    if len(losses) != TRAIN_EPOCHS or not tail < 0.5 * losses[0]:
        raise AssertionError(f"train recipe: {len(losses)} epoch records, the last 10 "
                             f"epochs' loss {tail:.4f} vs epoch 0's {losses[0]:.4f}")
    step_ms, img_s = map(float, re.search(r"median step ([0-9.]+) ms \(([0-9.]+) img/s",
                                          steps_line).groups())
    out["recipe"] = {"wall_s": wall, "median_step_ms": step_ms, "img_per_s": img_s,
                     "first_loss": losses[0], "last10_loss": tail}

    # the EMA weights of the last checkpoint, one member, no TTA
    ckpt = workdir / "checkpoints" / "last"
    saved, ckpt_cfg, meta = load_checkpoint(ckpt)
    built = build_model(ckpt_cfg, device="cuda")
    built.module.load_state_dict(flax_to_torch(saved["ema_params"]))
    sampler = make_sampler(built, SamplerSpec(n_pred=1, n_members=1, member_mode="single"))
    q32 = toy128_quality_eval(built, sampler, ckpt_cfg.data, batch=BATCH, hw=HW,
                              device="cuda", num_images=32)
    q = toy128_quality_eval(built, sampler, ckpt_cfg.data, batch=BATCH, hw=HW, device="cuda")
    log(f"train recipe quality (EMA weights of epoch {meta['epoch']}, one member, no TTA): "
        f"first 32 test images {q32} (bands {TRAIN_BANDS}); all 256 {q}")
    for metric, (lo, hi) in TRAIN_BANDS.items():
        if not lo <= q32[metric] <= hi:
            raise AssertionError(f"trained {metric} {q32[metric]:.5f} on the first 32 images "
                                 f"outside [{lo}, {hi}]")
    out["quality_32"], out["quality"] = q32, q

    argv = ["--checkpoint_paths", str(ckpt), "--test_split", "id", "--n_pred", "1",
            "--n_models", "1", "--ema_mode", "true", "--test_batch_size", str(BATCH),
            "--metrics_only", "--save_dir", str(Path(tmp) / "results")]
    job = subprocess.run([sys.executable, "-m", "diffuncertainty_tpu_torch.infer", *argv],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    if job.returncode != 0:
        raise AssertionError(f"the inference job on the trained checkpoint exited "
                             f"{job.returncode}:\n{job.stdout[-2000:]}\n{job.stderr[-4000:]}")
    (summary,) = [ast.literal_eval(ln) for ln in job.stdout.splitlines()
                  if ln.startswith("{'split'")]
    metrics = json.loads((Path(summary["out_dir"]) / "metrics.json").read_text())
    job_dice = float(np.mean([r["metrics"]["dice"] for r in metrics.values()]))
    log(f"infer job on the trained checkpoint: {summary}; mean Dice {job_dice:.6f} vs "
        f"{q['dice']:.6f} in process")
    if len(metrics) != 256 or abs(job_dice - q["dice"]) > 1e-4:
        raise AssertionError(f"infer job Dice {job_dice:.6f} over {len(metrics)} images != "
                             f"{q['dice']:.6f} to 1e-4")
    out["infer_dice"] = job_dice
    return out


def training_sites(trainer, batch) -> tuple[dict, list]:
    """The attention sites {T: (calls, C)} and the GroupNorm sites (shape
    without the batch, dtype, act), in call order, of one training forward
    of ``trainer``'s family and phase (no gradient taken)."""
    import torch

    from diffuncertainty_tpu_torch.models.unet import AttentionBlock, GroupNorm32

    attn_seen, norm_seen = [], []
    hooks = [m.register_forward_pre_hook(
        (lambda mod, args: attn_seen.append(tuple(args[0].shape))) if isinstance(m, AttentionBlock)
        else (lambda mod, args: norm_seen.append(
            (tuple(args[0].shape[1:]), str(args[0].dtype).split(".")[-1], mod.act))))
        for m in trainer.built.module.modules() if isinstance(m, (AttentionBlock, GroupNorm32))]
    with torch.no_grad():
        trainer.forward_loss(batch, torch.Generator("cuda").manual_seed(3))
    for h in hooks:
        h.remove()
    attn = {}
    for _, hh, ww, c in attn_seen:
        calls, _ = attn.get(hh * ww, (0, c))
        attn[hh * ww] = (calls + 1, c)
    return attn, norm_seen


def counted_grads(trainer, state, batch, seed: int) -> dict:
    """Launches, backward launches and twin VJPs of one forward and
    backward, the counts set to 0 just before and read just after; fails if
    a plain twin ran."""
    import torch

    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn

    torch.cuda.synchronize()
    with counting_twins() as twins:
        ca.reset_launch_count()
        gn.reset_launch_count()
        loss, _ = trainer.forward_loss(batch, torch.Generator("cuda").manual_seed(seed))
        trainer.gradients(state, loss)
        torch.cuda.synchronize()
        counts = step_counts()
    if any(twins.values()):
        raise AssertionError(f"plain twins ran in the counted step: {twins}")
    return counts


def phase_train_family(smi: str, model: str, runs) -> Generator[None, None, dict]:
    """One family's training (``TRAIN_FAMILIES``): each kernel's backward at
    its training shapes, one counted bf16 step at batch 16 (the SSN's also
    in its mean-only phase), a short run through the entry point as a
    subprocess (an entry-point run), and its checkpoint in the family's serving
    sampler (launches counted) and in the inference job."""
    import ast

    import numpy as np
    import torch

    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset
    from diffuncertainty_tpu_torch.tools.train_recipe import load_trained, recipe_tokens
    from diffuncertainty_tpu_torch.train.cli import build_loaders, parse_args
    from diffuncertainty_tpu_torch.train.loop import Trainer

    fam = TRAIN_FAMILIES[model]
    label = f"train_{model}"
    data_dir = toy128_dataset(HW).base_dir
    out = {}
    tmp = runs.dir(label)
    tokens = recipe_tokens(data_dir, tmp, model=model, epochs=fam["epochs"]) + fam["extra"]
    cfg, _ = parse_args(tokens)
    trainer = Trainer(cfg, device="cuda", workdir=runs.dir(f"{label}_probe"))
    full_epoch = cfg.model.ssn_pretrain_epochs  # 0 but for the SSN
    trainer.set_epoch(full_epoch)
    train_loader, _, _ = build_loaders(cfg)
    batches = list(train_loader)[:2]
    trainer.init_state()
    attn_sites, norm_sites = training_sites(trainer, batches[0])
    attn_cases, norm_cases = vjp_cases(norm_sites, attn_sites)
    out["attention_backward"], out["group_norm_backward"] = attn_cases, norm_cases
    attn_checked = {(c["B"], c["T"], c["C"]) for c in attn_cases}
    norm_checked = {(tuple(c["shape"]), c["dtype"], c["act"]) for c in norm_cases}
    out["step"] = phase_train_step(smi, trainer, batches, attn_checked, norm_checked,
                                   want=fam["step"], want_bwd=fam.get("step_bwd"),
                                   label=f"{label} step", runs=5)
    if "mean_only_step" in fam:  # the pretraining epochs skip the factor head
        trainer.set_epoch(0)
        counts = counted_grads(trainer, trainer.fresh_state(), batches[1], 11)
        want = want_counts(fam["mean_only_step"])
        log(f"{label} mean-only step: launches, backward launches and twin VJPs {counts} "
            f"(expected {want})")
        if counts != want:
            raise AssertionError(f"{label} mean-only step: {counts} != {want}")
        out["mean_only_launches"] = counts
    del trainer, batches
    torch.cuda.empty_cache()
    yield  # the rest is not timed: it waits for the entry-point run

    wall, text = run_output(runs, label)
    (steps_line,) = [ln for ln in text.splitlines() if ln.startswith("steps ")]
    workdir = Path(tmp) / cfg.auto_exp_name / "version_0"
    records = [json.loads(ln) for ln in (workdir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in records]
    vals = [r for r in records if "val_dice" in r]
    log(f"{label} run: exit 0 in {wall:.1f}s (process included, {BESIDE}) on "
        f"{smi}: {steps_line}; "
        f"train_loss by epoch {[round(x, 5) for x in losses]}; validation {vals}")
    if (len(losses) != fam["epochs"] or not np.isfinite(losses).all()
            or not losses[-1] < losses[0]):
        raise AssertionError(f"{label} run: losses {losses} not {fam['epochs']} finite and "
                             f"falling")
    if model == "ssn":
        failed = [r["train_cov_failed"] for r in records]
        log(f"{label} run: cov_failed by epoch {failed} (the factor head from epoch "
            f"{cfg.model.ssn_pretrain_epochs} on)")
        out["cov_failed"] = failed
    if model == "prob_unet":
        betas = [r["beta"] for r in records]
        log(f"{label} run: beta by epoch {betas}")
        if not all(a < b for a, b in zip(betas, betas[1:])):
            raise AssertionError(f"{label} run: beta {betas} is not rising")
        out["beta"] = betas
    if model == "diffusion" and len(vals) != fam["epochs"] // 2:
        raise AssertionError(f"{label} run: {len(vals)} validations (DDPM), expected "
                             f"{fam['epochs'] // 2}")
    out["run"] = {"wall_s": wall, "steps_line": steps_line, "losses": losses}

    # the checkpoint's EMA weights in the family's serving sampler
    ckpt = workdir / "checkpoints" / "last"
    built, sampler, ckpt_cfg = load_trained(ckpt)
    images = test_images(ckpt_cfg)
    stack, launches, _, _, _, _ = counted_call(built, sampler, images, 0)
    n_attn, n_norm = fam["serve"]
    check_launches(f"{label} checkpoint in the serving sampler", launches,
                   {"qkv_attention": n_attn, "group_norm_act": n_norm})
    check_stack(f"{label} checkpoint in the serving sampler", stack)
    out["serve_launches"] = launches
    del built, sampler, stack

    argv = ["--checkpoint_paths", str(ckpt), "--test_split", "id", "--n_pred",
            str(SAMPLES), "--n_models", "1", "--ema_mode", "true", "--test_batch_size",
            str(BATCH), "--metrics_only", "--save_dir", str(Path(tmp) / "results")]
    if model == "diffusion":
        argv += ["--diffusion-sampler", "ddim", "--diffusion-num-steps", str(DDIM_STEPS)]
    job = subprocess.run([sys.executable, "-m", "diffuncertainty_tpu_torch.infer", *argv],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    if job.returncode != 0:
        raise AssertionError(f"{label}: the inference job exited {job.returncode}:\n"
                             f"{job.stdout[-2000:]}\n{job.stderr[-4000:]}")
    (summary,) = [ast.literal_eval(ln) for ln in job.stdout.splitlines()
                  if ln.startswith("{'split'")]
    metrics = json.loads((Path(summary["out_dir"]) / "metrics.json").read_text())
    dice = [r["metrics"]["dice"] for r in metrics.values()]
    log(f"{label}: infer job on its checkpoint: {summary}; mean Dice {np.mean(dice):.5f}")
    if len(dice) != 256 or not all(0.0 <= d <= 1.0 for d in dice):
        raise AssertionError(f"{label}: infer job gave {len(dice)} records")
    out["infer"] = {"images_per_sec": summary.get("images_per_sec"),
                    "mean_dice": float(np.mean(dice))}
    torch.cuda.empty_cache()
    return out


# how the entry-point runs' walls and steps were taken: not a time to compare
BESIDE = f"up to {ENTRY_JOBS} runs at once"


def run_output(runs, name: str) -> tuple[float, str]:
    """(wall seconds, output) of a finished entry-point run; raises if it failed."""
    run = runs.wait(name)
    return run["wall_s"], run["output"]


def steps_line(label: str, text: str) -> str:
    lines = [ln for ln in text.splitlines() if ln.startswith("steps ")]
    if len(lines) != 1:
        raise AssertionError(f"{label}: no closing steps line in its output:\n{text[-2000:]}")
    return lines[0]


def run_records(workdir: Path) -> list[dict]:
    return [json.loads(ln) for ln in (workdir / "metrics.jsonl").read_text().splitlines()]


def register_entry_runs(runs, paths) -> None:
    """The chosen paths' entry-point runs (``TRAIN_FAMILIES``,
    ``NEW_TRAIN_RUNS``, the train path's recipe and the study)."""
    from diffuncertainty_tpu_torch.tools.multiclass_quality import (default_data_dir,
                                                                    gta_toy_frames)
    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset
    from diffuncertainty_tpu_torch.tools.train_recipe import multiclass_tokens, recipe_tokens

    data_dir = toy128_dataset(HW).base_dir if any(p.startswith("train") for p in paths) else None
    train = [sys.executable, "-m", "diffuncertainty_tpu_torch.train"]
    if "train" in paths:
        runs.add("train", train + train_tokens(data_dir, runs.dir("train")), 900)
    for path, spec in NEW_TRAIN_RUNS.items():
        if path not in paths:
            continue
        if path == "train_multiclass":
            gta_toy_frames(MC_FRAMES, MC_SIZE, MC_WINDOW, MC_SEED)  # the data tree
            runs.add(path, [sys.executable, "-m", "diffuncertainty_tpu_torch.tools.train_recipe",
                            "--multiclass-run", *multiclass_tokens(
                                default_data_dir(), runs.dir(path), spec["epochs"]),
                            *spec["extra"]], 600)
            continue
        for i, seed in enumerate(spec.get("seeds", (None,))):
            name = path if seed is None else f"{path}_{i}"
            runs.add(name, train + recipe_tokens(data_dir, runs.dir(name), model=spec["recipe"],
                                                 seed=seed, epochs=spec["epochs"])
                     + spec["extra"], 600)
    for model, fam in TRAIN_FAMILIES.items():
        if f"train_{model}" in paths:
            tokens = recipe_tokens(data_dir, runs.dir(f"train_{model}"), model=model,
                                   epochs=fam["epochs"]) + fam["extra"]
            runs.add(f"train_{model}", train + tokens, 600)
    if "study" in paths:
        runs.add("study", [sys.executable, "-m", "diffuncertainty_tpu_torch.tools.values_study",
                           str(runs.dir("study") / "work"), *STUDY_ARGV], 600)


def trained_run(runs, name: str, epochs: int) -> tuple[Path, dict]:
    """The checkpoint directory of a finished run and its summary (wall,
    steps line, losses by epoch); the loss must fall and stay finite."""
    import numpy as np

    wall, text = run_output(runs, name)
    line = steps_line(name, text)
    (workdir,) = [p for p in runs.dir(name).glob("*/version_0") if p.is_dir()]
    records = run_records(workdir)
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    log(f"{name} run: exit 0 in {wall:.1f}s (process included, {BESIDE}): {line}; "
        f"train_loss by epoch {[round(x, 5) for x in losses]}; validation "
        f"{[r for r in records if 'val_dice' in r]}")
    if len(losses) != epochs or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} run: losses {losses} not {epochs} finite and falling")
    return workdir / "checkpoints" / "last", {"wall_s": wall, "steps_line": line,
                                              "losses": losses}


_TRAIN_CHECKS: dict = {}


def unet16_train_checks(norm_site_list) -> tuple[list, list, set, set]:
    """Each kernel's backward at unet16's training shapes (16 rows), computed
    once for every training path that runs them: (attention cases, norm
    cases, attention shapes checked, norm sites checked)."""
    if not _TRAIN_CHECKS:
        attn_cases, norm_cases = vjp_cases(norm_site_list)
        _TRAIN_CHECKS["v"] = (attn_cases, norm_cases,
                              {(c["B"], c["T"], c["C"]) for c in attn_cases},
                              {(tuple(c["shape"]), c["dtype"], c["act"]) for c in norm_cases})
    return _TRAIN_CHECKS["v"]


def grad_rel_errors(names, got, ref, floor: float = 1e-8) -> dict:
    """Relative L2 error per leaf, leaves whose reference gradient is below
    ``floor`` of the largest leaf's norm left out (float rounding only)."""
    norms = {n: r.float().norm().item() for n, r in zip(names, ref)}
    top = max(norms.values())
    return {n: ((g.float() - r.float()).norm() / r.float().norm()).item()
            for n, g, r in zip(names, got, ref) if norms[n] > floor * top}


def phase_remat_step(smi: str, cfg, batches) -> dict:
    """``trainer.remat`` on the train path's step (from step 2): the counted
    remat forward and backward (each kernel's forward twice: the stored
    forward and the recompute; VJPs once), its gradients against the
    non-remat step's on the same generator state (fp32 to 1e-6 of the
    largest gradient, bf16 to STEP_GRAD_TOL), and the peak memory of a
    forward and backward with and without remat."""
    import torch

    from diffuncertainty_tpu_torch.core.config import apply_overrides
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
    from diffuncertainty_tpu_torch.train.loop import Trainer

    out = {}
    for precision in ("bf16", "fp32"):
        pcfg = apply_overrides(cfg, [f"trainer.precision={precision}"])
        plain = Trainer(pcfg, device="cuda", workdir=Path(cfg.save_dir) / f"plain_{precision}")
        remat = Trainer(apply_overrides(pcfg, ["trainer.remat=true"]), device="cuda",
                        workdir=Path(cfg.save_dir) / f"remat_{precision}")
        state = plain.init_state()
        for i in range(2):
            state, _ = plain.train_step(state, batches[i], plain.epoch_generator(0))
        remat.built.module.load_state_dict(plain.built.module.state_dict())
        names = list(state.params)

        def grads(trainer, seed=7):
            gen = torch.Generator("cuda").manual_seed(seed)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss, _ = trainer.forward_loss(batches[1], gen)
            g = trainer.gradients(trainer.fresh_state(), loss)
            torch.cuda.synchronize()
            return loss.item(), g, torch.cuda.max_memory_allocated() / 2**30

        if precision == "bf16":
            grads(remat)  # warm
            with counting_twins() as twins:
                ca.reset_launch_count()
                gn.reset_launch_count()
                grads(remat)
                counts = step_counts()
            want = want_counts((22, 112), (11, 56))
            log(f"train remat step: launches, backward launches and twin VJPs {counts} "
                f"(expected {want}: the forward and its recompute), twin forwards {twins}")
            if counts != want or any(twins.values()):
                raise AssertionError(f"train remat step: {counts} != {want} or twins ran {twins}")
            out["launches"] = counts
        loss, g, peak = grads(plain)
        r_loss, r_g, r_peak = grads(remat)
        if precision == "fp32":
            top = max(x.abs().max().item() for x in g)
            worst = max((a - b).abs().max().item() for a, b in zip(r_g, g))
            log(f"train remat step fp32: loss {r_loss:.7f} vs {loss:.7f}; max |g_remat - g| "
                f"{worst:.3e} ({worst / top:.3e} of the largest gradient)")
            if worst > 1e-6 * top or abs(r_loss - loss) > 1e-6 * abs(loss):
                raise AssertionError(f"remat fp32 gradients differ: {worst:.3e} of {top:.3e}")
            out["fp32_max_rel"] = worst / top
        else:
            rel = grad_rel_errors(names, r_g, g)
            worst = max(rel, key=rel.get)
            log(f"train remat step bf16 on {smi}: loss {r_loss:.6f} vs {loss:.6f}; gradient rel "
                f"L2 per leaf max {rel[worst]:.3e} at {worst} ({len(rel)} leaves); peak memory "
                f"of a forward and backward {r_peak:.3f} GiB with remat, {peak:.3f} GiB without")
            if rel[worst] > STEP_GRAD_TOL:
                raise AssertionError(f"remat bf16 gradient {worst} rel error {rel[worst]:.3e}")
            out.update(bf16_max_rel=rel[worst], peak_gib_remat=r_peak, peak_gib_plain=peak)
        del plain, remat, state, g, r_g
        torch.cuda.empty_cache()
    return out


def hrnet_bn_inputs(module, box: list):
    """A hook recording the first BatchNorm's input (the stem's) of each forward."""
    return module.stem_bn1.register_forward_pre_hook(
        lambda mod, args: box.append(args[0].detach().clone()))


def phase_train_hrnet(smi: str, runs) -> Generator[None, None, dict]:
    """The HRNet's training: one counted bf16 step at batch 16 (no kernel,
    no twin), every leaf's gradient against the fp32 step with the same
    draws, the running statistics after a step by flax's rule (0.9 running +
    0.1 the batch's float32 biased statistics), a remat step leaving them
    identical, the step's split; then the short run through the entry point
    and its checkpoint (EMA weights and the run's statistics) in the HRNet
    serving path."""
    import copy

    import torch

    from diffuncertainty_tpu_torch.core.config import apply_overrides
    from diffuncertainty_tpu_torch.core.params import load_into
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
    from diffuncertainty_tpu_torch.sampling.sampler import SamplerSpec, make_sampler
    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset, toy128_quality_eval
    from diffuncertainty_tpu_torch.tools.train_recipe import TTA, load_trained, recipe_tokens
    from diffuncertainty_tpu_torch.train.cli import build_loaders, parse_args
    from diffuncertainty_tpu_torch.train.loop import Trainer

    spec = NEW_TRAIN_RUNS["train_hrnet"]
    tmp = runs.dir("train_hrnet_probe")
    cfg, _ = parse_args(recipe_tokens(toy128_dataset(HW).base_dir, tmp, model="hrnet",
                                      epochs=spec["epochs"]))
    trainer = Trainer(cfg, device="cuda", workdir=tmp / "bf16")
    batches = list(build_loaders(cfg)[0])[:2]
    state = trainer.init_state()
    module = trainer.built.module
    out = {}

    def grads(tr, seed=7):
        gen = torch.Generator("cuda").manual_seed(seed)
        loss, aux = tr.forward_loss(batches[0], gen)
        return loss, tr.gradients(tr.fresh_state(), loss), aux

    grads(trainer)  # warm
    torch.cuda.synchronize()
    with counting_twins() as twins:
        ca.reset_launch_count()
        gn.reset_launch_count()
        loss, g, _ = grads(trainer)
        torch.cuda.synchronize()
        counts = step_counts()
    log(f"train_hrnet step: launches, backward launches and twin VJPs {counts} (the HRNet has "
        f"neither kernel), twin forwards {twins}")
    if any(counts.values()) or any(twins.values()):
        raise AssertionError(f"train_hrnet step launched {counts} or twins {twins}")
    out["launches"] = {k: v for k, v in counts.items() if not k.endswith("_vjp")}
    # every leaf of the bf16 and the fp32 step against a float64 step, the
    # same draws, at the trained asset's weights and statistics
    steps = {}
    for precision, dtype in (("bf16", None), ("fp32", None), ("fp64", torch.float64)):
        tr = Trainer(apply_overrides(cfg, [f"trainer.precision="
                                           f"{'fp32' if dtype else precision}"]),
                     device="cuda", workdir=tmp / precision)
        load_into(tr.built.module, ASSET_HRNET)
        if dtype is not None:
            tr.built.module.double()
            tr.built.module.dtype = dtype
        loss_p, g_p, _ = grads(tr)
        steps[precision] = (loss_p.item(), g_p)
        del tr
    names = list(state.params)
    g64 = steps["fp64"][1]
    top = max(x.norm().item() for x in g64)
    keep = [i for i, x in enumerate(g64) if x.norm().item() > 1e-6 * top]
    stats_g = {}
    for precision in ("bf16", "fp32"):
        gp = steps[precision][1]
        per = [((gp[i].double() - g64[i]).norm() / g64[i].norm()).item() for i in keep]
        # each leaf's own cosine (0 for a leaf whose gradient is all zeros)
        cos = [(gp[i].double().reshape(-1) @ g64[i].reshape(-1)
                / (gp[i].double().norm() * g64[i].norm()).clamp(min=1e-300)).item() for i in keep]
        a = torch.cat([gp[i].double().reshape(-1) for i in keep])
        b = torch.cat([g64[i].reshape(-1) for i in keep])
        stats_g[precision] = {"loss": steps[precision][0],
                              "cos": (a @ b / a.norm() / b.norm()).item(),
                              "median_rel": statistics.median(per), "max_rel": max(per),
                              "worst": names[keep[per.index(max(per))]], "min_leaf_cos": min(cos),
                              "worst_cos": names[keep[cos.index(min(cos))]],
                              "finite": all(torch.isfinite(x).all().item() for x in gp)}
    log(f"train_hrnet step gradients at the trained weights against a float64 step (same "
        f"draws; {len(keep)} of {len(names)} leaves, the rest below 1e-6 of the largest: "
        f"biases before a train-mode BatchNorm): float64 loss {steps['fp64'][0]:.6f}; "
        f"{stats_g}")
    b16, f32 = stats_g["bf16"], stats_g["fp32"]
    if not (f32["finite"] and b16["finite"] and f32["max_rel"] <= HRNET_FP32_TOL
            and b16["cos"] >= HRNET_BF16_COS and b16["max_rel"] <= HRNET_BF16_LEAF
            and b16["min_leaf_cos"] >= HRNET_BF16_LEAF_COS):
        raise AssertionError(f"train_hrnet gradients: {stats_g} (fp32 per leaf <= "
                             f"{HRNET_FP32_TOL}; bf16 cosine >= {HRNET_BF16_COS}, per leaf <= "
                             f"{HRNET_BF16_LEAF} and each leaf's cosine >= {HRNET_BF16_LEAF_COS})")
    out["gradients_vs_fp64"] = stats_g
    del steps, g64
    # the statistics after one step by flax's rule, and a remat step the same
    tremat = Trainer(apply_overrides(cfg, ["trainer.remat=true"]), device="cuda",
                     workdir=tmp / "remat")
    tremat.built.module.load_state_dict(module.state_dict())
    before = {k: v.clone() for k, v in state.model_state.items()}
    box: list = []
    hook = hrnet_bn_inputs(module, box)
    state, _ = trainer.train_step(state, batches[0], torch.Generator("cuda").manual_seed(7))
    hook.remove()
    x = box[0].float()
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    for k, batch_v in (("stem_bn1.running_mean", mean), ("stem_bn1.running_var", var)):
        want = 0.9 * before[k] + 0.1 * batch_v
        err = (state.model_state[k] - want).abs().max().item()
        if err > 1e-5 * max(1.0, want.abs().max().item()):
            raise AssertionError(f"train_hrnet {k} after a step {err:.3e} from flax's rule")
    moved = sum(not torch.equal(before[k], v) for k, v in state.model_state.items())
    rstate = tremat.fresh_state()
    tremat.train_step(rstate, batches[0], torch.Generator("cuda").manual_seed(7))
    diff = max((a - b).abs().max().item() for a, b in zip(
        rstate.model_state.values(), state.model_state.values()))
    log(f"train_hrnet statistics: {moved} of {len(before)} buffers moved by 0.9 running + 0.1 "
        f"the batch's (stem checked to 1e-5); after a remat step max |d| {diff:.3e}")
    if moved != len(before) or diff > 1e-6:
        raise AssertionError(f"train_hrnet statistics: {moved} moved, remat differs by {diff}")
    del tremat, rstate
    # the step's split, busy share and peak memory
    out["step"] = phase_train_step(smi, trainer, batches, set(), set(),
                                   want=(0, 0), label="train_hrnet step", runs=5,
                                   compare_twins=False)
    del trainer, state
    torch.cuda.empty_cache()
    yield  # the rest is not timed: it waits for the entry-point run

    ckpt, out["run"] = trained_run(runs, "train_hrnet", spec["epochs"])
    built, _, ckpt_cfg = load_trained(ckpt)
    saved_stats = copy.deepcopy({k: v for k, v in built.module.state_dict().items()
                                 if "running" in k})
    sampler = make_sampler(built, SamplerSpec(n_pred=1, n_members=MEMBERS, tta=True,
                                              tta_config=TTA, member_mode="dropout"))
    images = test_images(ckpt_cfg)
    stack, launches, _, _, _, _ = counted_call(built, sampler, images, 0)
    check_launches("train_hrnet checkpoint in the hrnet path", launches,
                   {"qkv_attention": 0, "group_norm_act": 0})
    check_stack("train_hrnet checkpoint in the hrnet path", stack)
    out["serve_eu"] = mean_eu("train_hrnet checkpoint in the hrnet path", stack)
    if not all(torch.equal(v, built.module.state_dict()[k]) for k, v in saved_stats.items()):
        raise AssertionError("serving moved the HRNet's statistics")
    out["quality_32"] = toy128_quality_eval(built, sampler, ckpt_cfg.data, batch=BATCH, hw=HW,
                                            device="cuda", num_images=32)
    log(f"train_hrnet checkpoint quality ({spec['epochs']} epochs, 16 members x TTA, first 32 "
        f"test images): {out['quality_32']}")
    del built, sampler, stack
    torch.cuda.empty_cache()
    return out


def serve_stack(label: str, cfg, built, sampler, attn_checked, norm_checked, want, seed):
    """A member-stack sampler: its new kernel shapes against the twins, the
    counted call (launches ``want``), the stack and its EU, and quality on
    the first 32 test images."""
    from diffuncertainty_tpu_torch.tools.quality import toy128_quality_eval

    images = test_images(cfg)
    attn_cases, norm_cases = check_sites(sampler, images, attn_checked, norm_checked, seed)
    stack, launches, _, _, _, _ = counted_call(built, sampler, images, 0)
    check_launches(f"{label} (blocks {sampler.blocks})", launches,
                   {"qkv_attention": want[0], "group_norm_act": want[1]})
    check_stack(label, stack)
    eu = mean_eu(label, stack)
    q = toy128_quality_eval(built, sampler, cfg.data, batch=BATCH, hw=HW,
                            device="cuda", num_images=32)
    log(f"{label} quality (first 32 test images): {q}")
    return {"launches": launches, "mean_eu": eu, "quality_32": q, "blocks": sampler.blocks,
            "attn_cases": attn_cases, "norm_cases": norm_cases}


def phase_train_subensemble(smi: str, norm_site_list, seen_attn: set,
                            seen_norm: set) -> Generator[None, None, dict]:
    """The sub-ensemble mask trainer over the frozen softmax asset
    (``bench_unet16_toy128.npz``, unet16 bf16, no dropout): each kernel's
    backward at its 16-row member forwards, one counted step (the members'
    forwards and VJPs through both kernels, no twin), a short run with the
    loss falling, the masks' hard IoU below 1 and expected fill near the
    target, and the materialized members folded in the sampler with EU > 0."""
    import torch

    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.core.params import load_into
    from diffuncertainty_tpu_torch.data.augment import normalize_batch
    from diffuncertainty_tpu_torch.data.dataset import MultiRaterDataset
    from diffuncertainty_tpu_torch.data.loader import BatchLoader
    from diffuncertainty_tpu_torch.models import subensemble as se
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
    from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
    from diffuncertainty_tpu_torch.sampling.sampler import SamplerSpec, make_sampler
    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset
    from diffuncertainty_tpu_torch.tools.train_recipe import TTA
    from diffuncertainty_tpu_torch.train import subensemble_trainer as st

    unet16_train_checks(norm_site_list)
    cfg = load_config(data="lidc128", network="unet16", model="softmax", eu_method="none",
                      precision="bf16")
    built = build_model(cfg, device="cuda")
    load_into(built.module, ASSET)
    state = dict(built.module.state_dict())
    toy = toy128_dataset(HW).base_dir
    ds = MultiRaterDataset(toy / "splits" / "default" / "firstCycle" / "splits.pkl", toy,
                           split="train", return_all_raters=False)
    aug = cfg.data.augmentations
    batches = [{"image": normalize_batch(torch.from_numpy(b["image"]).cuda(), aug.mean, aug.std),
                "seg": torch.from_numpy(b["seg"]).cuda()}
               for _, b in zip(range(2), BatchLoader(ds, BATCH, shuffle=True, seed=0))]
    scfg = st.SubensembleConfig(**SUBENSEMBLE)
    torch.cuda.synchronize()
    with counting_twins() as twins:
        ca.reset_launch_count()
        gn.reset_launch_count()
        st.train_subensemble_masks(built, state, batches,
                                   st.SubensembleConfig(**{**SUBENSEMBLE, "steps": 1}))
        torch.cuda.synchronize()
        counts = step_counts()
    m = scfg.num_masks
    want = want_counts((11 * m, 56 * m))
    log(f"train_subensemble step ({m} members one after another): launches, backward launches "
        f"and twin VJPs {counts} (expected {want}), twin forwards {twins}")
    if counts != want or any(twins.values()):
        raise AssertionError(f"train_subensemble step: {counts} != {want} or twins {twins}")
    history: list = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = st.train_subensemble_masks(built, state, batches, scfg, history=history)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = se.compute_mask_stats(masks)
    log(f"train_subensemble run on {smi}: {scfg.steps} steps in {wall:.1f}s "
        f"({wall / scfg.steps * 1e3:.1f} ms a step, {m} members); loss by step "
        f"{[round(h['loss'], 4) for h in history]}, iou {[round(h['iou'], 4) for h in history]}, "
        f"size {[round(h['size'], 4) for h in history]}; hard masks: mean fill "
        f"{stats['mean_fill_fraction']:.4f} (target {scfg.target_fraction}), mean pairwise IoU "
        f"{stats['mean_pairwise_iou']:.4f}, fill per member "
        f"{[round(f, 4) for f in stats['fill_fraction_per_member']]}")
    # the fill the size penalty acts on: per layer and member the expected
    # share of kept weights, mean(sigmoid(2 l_out)) * mean(sigmoid(2 l_in))
    fill = float(torch.stack([(torch.sigmoid(2 * d["out"]).mean(1)
                               * torch.sigmoid(2 * d["in"]).mean(1)).mean()
                              for d in masks.values()]).mean())
    log(f"train_subensemble: expected fill {fill:.4f} (target {scfg.target_fraction}, band "
        f"{SUBENSEMBLE_FILL_BAND})")
    if not (history[-1]["loss"] < history[0]["loss"] and stats["mean_pairwise_iou"] < 1.0
            and abs(fill - scfg.target_fraction) < SUBENSEMBLE_FILL_BAND):
        raise AssertionError(f"train_subensemble: loss not falling, IoU "
                             f"{stats['mean_pairwise_iou']}"
                             f" or expected fill {fill} not near the target")
    yield  # the rest is not timed: it runs beside the entry-point runs
    members = st.materialize_for_inference(state, masks, m, rows_only=scfg.rows_only,
                                           normalize=scfg.normalize)
    sampler = make_sampler(built, SamplerSpec(n_pred=1, n_members=m, tta=True, tta_config=TTA,
                                              member_mode="params_stack"), members=members)
    served = serve_stack("train_subensemble members folded", cfg, built, sampler, seen_attn,
                         seen_norm, (11, 56), seed=1500)
    del sampler, members
    # the JAX defaults (normalize, diversity 1.0) over the same steps:
    # tests/test_torch_port_subensemble_train.py holds the port's hard masks and
    # EU there to the JAX trainer's; here what they give on unet16
    dcfg = st.SubensembleConfig(**SUBENSEMBLE_DEFAULTS)
    dhistory: list = []
    dmasks = st.train_subensemble_masks(built, state, batches, dcfg, history=dhistory)
    dstats = se.compute_mask_stats(dmasks)
    dmembers = st.materialize_for_inference(state, dmasks, m, normalize=True)
    images = test_images(cfg)
    dstack = make_sampler(built, SamplerSpec(n_pred=1, n_members=m, member_mode="params_stack"),
                          members=dmembers)(images, torch.Generator("cuda").manual_seed(0))
    check_stack("train_subensemble with the JAX defaults", dstack)
    deu = uncertainty_heatmaps(dstack.group_means.float(), sample_axis=0,
                               class_axis=-1)["EU"].mean().item()
    head = dmasks["out_conv"]["out"] if "out_conv" in dmasks else None
    log(f"train_subensemble with the JAX defaults (normalize, diversity 1.0; not timed): loss "
        f"by step {[round(h['loss'], 4) for h in dhistory]}; hard masks: mean fill "
        f"{dstats['mean_fill_fraction']:.4f}, mean pairwise IoU "
        f"{dstats['mean_pairwise_iou']:.4f}; members' mean EU {deu:.4e}"
        + ("" if head is None else f"; the head's out-channel logits {head.tolist()}"))
    if not all(math.isfinite(h["loss"]) for h in dhistory):
        raise AssertionError(f"train_subensemble with the JAX defaults: losses {dhistory}")
    del built, dmembers, dstack, state, batches
    torch.cuda.empty_cache()
    return {"launches": {k: v for k, v in counts.items() if not k.endswith("_vjp")},
            "run": {"steps": scfg.steps, "wall_s": wall, "ms_per_step": wall / scfg.steps * 1e3,
                    "loss": [h["loss"] for h in history]},
            "mask_stats": {k: stats[k] for k in ("mean_fill_fraction", "mean_pairwise_iou")},
            "serve": served,
            "jax_defaults": {"loss": [h["loss"] for h in dhistory], "mean_eu": deu,
                             **{k: dstats[k] for k in ("mean_fill_fraction",
                                                        "mean_pairwise_iou")}}}


def phase_train_multiclass(smi: str, runs, norm_site_list, attn_checked168: set,
                           norm_checked168: set) -> Generator[None, None, dict]:
    """The multiclass recipe's trainer (gta-toy, switched single masks, 24
    classes): one counted bf16 step at batch 16 with the split, then the short
    run and its checkpoint through the multiclass path (8 members of 168
    rows, launches counted) and ``tools/multiclass_quality.py``."""
    import torch

    from diffuncertainty_tpu_torch.data.augment import normalize_batch
    from diffuncertainty_tpu_torch.data.cityscapes import CityscapesDataset
    from diffuncertainty_tpu_torch.data.loader import BatchLoader
    from diffuncertainty_tpu_torch.tools.multiclass_quality import (
        default_data_dir, gta_toy_frames, gta_toy_quality_eval, member_sliding_window_fn)
    from diffuncertainty_tpu_torch.tools.train_recipe import load_trained, multiclass_tokens
    from diffuncertainty_tpu_torch.train.cli import parse_args
    from diffuncertainty_tpu_torch.train.loop import Trainer

    attn_cases, norm_cases, attn_checked, norm_checked = unet16_train_checks(norm_site_list)
    spec = NEW_TRAIN_RUNS["train_multiclass"]
    data_dir = default_data_dir()
    cfg, _ = parse_args(multiclass_tokens(data_dir, runs.dir("train_multiclass_probe"),
                                          spec["epochs"]))
    trainer = Trainer(cfg, device="cuda", workdir=runs.dir("train_multiclass_probe") / "w")
    ds = CityscapesDataset(data_dir / "splits" / "default" / "firstCycle" / "splits.pkl",
                           data_dir, split="train", return_all_raters=False)
    batches = list(BatchLoader(ds, BATCH, shuffle=True, drop_last=True))[:2]
    out = {"step": phase_train_step(smi, trainer, batches, attn_checked, norm_checked,
                                    label="train_multiclass step", runs=5)}
    del trainer, batches
    torch.cuda.empty_cache()
    yield  # the rest is not timed: it waits for the entry-point run
    ckpt, out["run"] = trained_run(runs, "train_multiclass", spec["epochs"])
    built, _, ckpt_cfg = load_trained(ckpt)
    frames, _ = gta_toy_frames(MC_FRAMES, MC_SIZE, MC_WINDOW, MC_SEED)
    aug = ckpt_cfg.data.augmentations
    x = normalize_batch(torch.from_numpy(frames).cuda(), aug.mean, aug.std)
    fn = member_sliding_window_fn(built.module, window=MC_WINDOW, stride=MC_STRIDE,
                                  members=MC_MEMBERS)
    _, launches, _, _, attn_seen, norm_seen = counted_call(built, fn, x, MC_SEED)
    check_launches("train_multiclass checkpoint in the multiclass path", launches,
                   {"qkv_attention": MC_MEMBERS * 11, "group_norm_act": MC_MEMBERS * 56})
    if ({(b, hh * ww, c) for b, hh, ww, c in attn_seen} != attn_checked168
            or set(norm_seen) != norm_checked168):
        raise AssertionError("train_multiclass serving shapes were not checked")
    q = gta_toy_quality_eval(built, ckpt_cfg.data, frames=MC_FRAMES, frame_size=MC_SIZE,
                             window=MC_WINDOW, stride=MC_STRIDE, members=MC_MEMBERS, seed=MC_SEED,
                             timing_reps=1, device="cuda")
    log(f"train_multiclass checkpoint ({spec['epochs']} epochs) in tools/multiclass_quality.py: "
        f"{q}")
    out.update(serve_launches=launches, quality=q)
    del built, x
    torch.cuda.empty_cache()
    return out


def phase_train_swag(smi: str, runs, norm_site_list, seen_attn: set,
                     seen_norm: set) -> Generator[None, None, dict]:
    """The SWAG-diag recipe's trainer: one counted step (the softmax step),
    the short run collecting a snapshot each epoch, its moments as the asset
    stores them, 16 members drawn from them (generator seed 42) in the
    ensemble path, folded."""
    import torch

    from diffuncertainty_tpu_torch.core.checkpoint import load_checkpoint
    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset
    from diffuncertainty_tpu_torch.tools.train_recipe import (ensemble_path, recipe_tokens,
                                                              swag_members)
    from diffuncertainty_tpu_torch.train.cli import build_loaders, parse_args
    from diffuncertainty_tpu_torch.train.loop import Trainer

    attn_cases, norm_cases, attn_checked, norm_checked = unet16_train_checks(norm_site_list)
    spec = NEW_TRAIN_RUNS["train_swag"]
    cfg, _ = parse_args(recipe_tokens(toy128_dataset(HW).base_dir, runs.dir("train_swag_probe"),
                                      model="swag", epochs=spec["epochs"]))
    trainer = Trainer(cfg, device="cuda", workdir=runs.dir("train_swag_probe") / "w")
    batches = list(build_loaders(cfg)[0])[:2]
    trainer.init_state()
    state = trainer.fresh_state()
    counts = counted_grads(trainer, state, batches[1], 11)
    log(f"train_swag step: launches, backward launches and twin VJPs {counts}")
    if counts != want_counts((11, 56)):
        raise AssertionError(f"train_swag step: {counts}")
    del trainer, state, batches
    yield  # the rest waits for the entry-point run
    ckpt, run = trained_run(runs, "train_swag", spec["epochs"])
    saved, _, _ = load_checkpoint(ckpt)
    n = int(saved["swag_state"]["n_models"])
    log(f"train_swag run: {n} snapshots collected")
    if n != spec["epochs"]:
        raise AssertionError(f"train_swag collected {n} snapshots in {spec['epochs']} epochs")
    cfg_e, built, sampler = ensemble_path(swag_members(ckpt))
    served = serve_stack("train_swag members folded", cfg_e, built, sampler, seen_attn,
                         seen_norm, (11, 56), seed=1600)
    del built, sampler
    torch.cuda.empty_cache()
    return {"launches": {k: v for k, v in counts.items() if not k.endswith("_vjp")},
            "run": run, "snapshots": n, "serve": served}


def phase_train_ensemble(smi: str, runs, norm_site_list, seen_attn: set,
                         seen_norm: set) -> Generator[None, None, dict]:
    """The 16-member recipe cut to its first seeds: one counted member step,
    the members' short runs (entry-point runs), their raw weights
    stacked in the member config's sampler with TTA, folded."""
    import torch

    from diffuncertainty_tpu_torch.core.checkpoint import load_checkpoint
    from diffuncertainty_tpu_torch.core.params import flax_to_torch, stack_states
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.sampling.sampler import SamplerSpec, make_sampler
    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset
    from diffuncertainty_tpu_torch.tools.train_recipe import TTA, recipe_tokens
    from diffuncertainty_tpu_torch.train.cli import build_loaders, parse_args
    from diffuncertainty_tpu_torch.train.loop import Trainer

    unet16_train_checks(norm_site_list)
    spec = NEW_TRAIN_RUNS["train_ensemble"]
    seeds = spec["seeds"]
    cfg, _ = parse_args(recipe_tokens(toy128_dataset(HW).base_dir, runs.dir("train_ens_probe"),
                                      model="ensemble", seed=seeds[-1], epochs=spec["epochs"]))
    trainer = Trainer(cfg, device="cuda", workdir=runs.dir("train_ens_probe") / "w")
    batches = list(build_loaders(cfg)[0])[:2]
    trainer.init_state()
    counts = counted_grads(trainer, trainer.fresh_state(), batches[1], 13)
    log(f"train_ensemble member step (seed {seeds[-1]}): launches, backward launches and twin "
        f"VJPs {counts}")
    if counts != want_counts((11, 56)):
        raise AssertionError(f"train_ensemble step: {counts}")
    del trainer, batches
    yield  # the rest waits for the entry-point runs
    ckpts, run = [], {}
    for i in range(len(seeds)):
        ckpt, run[f"seed{seeds[i]}"] = trained_run(runs, f"train_ensemble_{i}", spec["epochs"])
        ckpts.append(ckpt)
    _, mcfg, _ = load_checkpoint(ckpts[0])
    built = build_model(mcfg, device="cuda")
    # the raw weights: after 24 steps the EMA (decay 0.999) is still about the
    # flax init, whose zero head predicts 0.5 everywhere (the recipe serves the EMA)
    stack = stack_states([flax_to_torch(load_checkpoint(c)[0]["params"]) for c in ckpts],
                         built.module)
    n = len(seeds)
    sampler = make_sampler(built, SamplerSpec(n_pred=1, n_members=n, tta=True, tta_config=TTA,
                                              member_mode="params_stack"),
                           members={k: v.cuda() for k, v in stack.items()})
    served = serve_stack(f"train_ensemble {n} members folded", mcfg, built, sampler, seen_attn,
                         seen_norm, (11, 56), seed=1700)
    del built, sampler
    torch.cuda.empty_cache()
    return {"launches": {k: v for k, v in counts.items() if not k.endswith("_vjp")},
            "run": run, "serve": served}


def phase_multiclass_quality() -> dict:
    from diffuncertainty_tpu_torch.tools.multiclass_quality import gta_toy_quality_eval

    cfg, built, _ = build_multiclass()
    t0 = time.perf_counter()
    q = gta_toy_quality_eval(built, cfg.data, frames=MC_FRAMES, frame_size=MC_SIZE,
                             window=MC_WINDOW, stride=MC_STRIDE, members=MC_MEMBERS,
                             seed=MC_SEED, timing_reps=3, device="cuda")
    log(f"quality multiclass_bf16 ({MC_FRAMES} frames, {MC_MEMBERS} members, "
        f"{time.perf_counter() - t0:.1f}s): {q}")
    for metric, ref in MULTICLASS_PARITY.items():
        if abs(q[metric] - ref) > MULTICLASS_BANDS[metric]:
            raise AssertionError(f"multiclass_bf16 {metric} {q[metric]:.5f} outside "
                                 f"{ref} +- {MULTICLASS_BANDS[metric]}")
    return q


def phase_quality(paths):
    from diffuncertainty_tpu_torch.tools.quality import toy128_quality_eval

    results = {}
    # (key, precision, separable warp, model, images scored); a key in PARITY is held
    for key, precision, separable, model, n_images in (
            ("bf16", "bf16", True, "softmax", None), ("fp32", "fp32", False, "softmax", None),
            ("bf16_32", "bf16", True, "softmax", 32),
            ("diffusion_bf16_32", "bf16", True, "diffusion", 32),
            ("diffusion_bf16", "bf16", True, "diffusion", None),
            ("ssn_bf16", "bf16", True, "ssn", None),
            ("prob_unet_bf16", "bf16", True, "prob_unet", None),
            ("ensemble_bf16", "bf16", True, "ensemble", None),
            ("hrnet_bf16_32", "bf16", True, "hrnet", 32),
            ("hrnet_bf16", "bf16", True, "hrnet", None)):
        if model not in paths:
            continue
        cfg, built, sampler = build_path(precision, separable, model)
        t0 = time.perf_counter()
        q = toy128_quality_eval(built, sampler, cfg.data, batch=BATCH, hw=HW, device="cuda",
                                num_images=n_images)
        log(f"quality {key} ({model}, {'separable' if separable else 'composed'} warp, "
            f"{n_images or 'all'} test images, {time.perf_counter() - t0:.1f}s): {q}")
        for metric, ref in PARITY.get(key, {}).items():
            if abs(q[metric] - ref) > BANDS[metric]:
                raise AssertionError(
                    f"{key} {metric} {q[metric]:.5f} outside {ref} +- {BANDS[metric]}")
        results[key] = q
        if key == "diffusion_bf16_32":
            # the spread of the held numbers over other random draws (not held)
            runs = [q] + [toy128_quality_eval(built, sampler, cfg.data, batch=BATCH, hw=HW,
                                              device="cuda", num_images=n_images,
                                              seed_base=seed)
                          for seed in (1000, 2000, 3000, 4000)]
            log(f"quality {key} over seed bases 777, 1000-4000: " + ", ".join(
                f"{m} {min(r[m] for r in runs):.5f}..{max(r[m] for r in runs):.5f}"
                for m in q))
    return results


def study_job_sites(job, images) -> tuple[list, list]:
    """Every attention input shape and GroupNorm site (shape, dtype, act,
    members) of one inference batch of a study job (uncounted)."""
    import torch

    with recording_sites(job.sampler) as (attn_seen, norm_seen):
        job._sample_stack(images, torch.Generator("cuda").manual_seed(98))
        torch.cuda.synchronize()
    return list(attn_seen), list(norm_seen)


def phase_study(smi: str, runs) -> Generator[None, None, dict]:
    """The study path. Timed part: one study net per AU type of the full
    study, each EU method of the quick matrix (a trainer on the study's own
    config and toy data, its flax init saved as the cell's checkpoint); the
    GroupNorm sites of one training forward (the study's batch, fp32) and of
    one inference batch of the cell's job, each new one checked against the
    twin, and the backward kernel at each new site of the training forward
    (:func:`norm_backward_case`); then every job's batch counted: GroupNorm launched once per site
    and its twin never, every attention call on the fp32 twin (the gate) and
    the attention kernel never. Then the quick study's run through its
    command line (queued with the training runs): every artifact and figure
    written, a finite softmax-entropy baseline, both AL directions computed,
    every version preflighted as not missing; its wall and each cell's
    train, infer and evaluate walls."""
    import tempfile

    import torch

    from diffuncertainty_tpu_torch.data.dataset import MultiRaterDataset
    from diffuncertainty_tpu_torch.data.loader import BatchLoader
    from diffuncertainty_tpu_torch.data.toy import generate_toy_dataset
    from diffuncertainty_tpu_torch.infer.runner import UncertaintyInference
    from diffuncertainty_tpu_torch.models.unet import GroupNorm32
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
    from diffuncertainty_tpu_torch.tools import values_study as vs
    from diffuncertainty_tpu_torch.train.loop import Trainer

    base = Path(tempfile.mkdtemp(prefix="chip_smoke_study_nets_"))
    checked, norm_cases, counted = set(), [], {}
    bwd_checked, norm_backward_cases = set(), []
    try:
        scfg = vs.study_config([str(base), *STUDY_ARGV])
        toy = generate_toy_dataset(
            base / "toy", num_train=scfg.num_train, num_val=scfg.num_val,
            num_test=scfg.num_test, num_ood=scfg.num_ood, size=scfg.image_size,
            ambiguity=scfg.ambiguity, seed=0, ood_shifts=scfg.ood_shifts,
            num_unlabeled=scfg.num_unlabeled)
        splits = toy / "splits" / "default" / "firstCycle" / "splits.pkl"
        train_batch = next(iter(BatchLoader(
            MultiRaterDataset(splits, toy, split="train", return_all_raters=False),
            scfg.batch_size, shuffle=True, seed=0)))
        test_images = next(iter(BatchLoader(MultiRaterDataset(splits, toy, split="id"),
                                            scfg.batch_size)))["image"]
        for au in STUDY_AU_TYPES:
            for eu in scfg.eu_methods:
                label = f"study {au}_{eu}"
                trainer = Trainer(vs._load_run_config(scfg, toy, au, eu, 0), device="cuda")
                state = trainer.init_state()
                train_seen = []
                hooks = [m.register_forward_pre_hook(lambda mod, args: train_seen.append(
                    (tuple(args[0].shape), str(args[0].dtype).split(".")[-1],
                     "none" if mod.act == "gelu" else mod.act, mod.members)))
                    for m in trainer.built.module.modules() if isinstance(m, GroupNorm32)]
                with torch.no_grad():
                    trainer.forward_loss(train_batch, torch.Generator("cuda").manual_seed(3))
                for h in hooks:
                    h.remove()
                trainer._save_last(state, 0)
                job = UncertaintyInference([trainer.workdir / "checkpoints" / "last"],
                                           vs.cell_inference_config(scfg, au, eu, 0))
                images = job.normalize(test_images)
                attn_seen, norm_seen = study_job_sites(job, images)
                for key in sorted(set(train_seen) | set(norm_seen)):
                    if key not in checked:
                        shape, dt, act, members = key
                        norm_cases.append(group_norm_case(
                            shape, dt, act, seed=800 + len(norm_cases), timed=False,
                            members=members))
                        checked.add(key)
                # the backward kernel at the training forward's sites (fp32, 8-32 channels)
                for key in sorted(set(train_seen) - bwd_checked):
                    shape, dt, act, members = key
                    norm_backward_cases.append(norm_backward_case(
                        shape, dt, act, train_seen.count(key), 850 + len(norm_backward_cases),
                        members=members, timed=False))
                    bwd_checked.add(key)
                torch.cuda.synchronize()
                with counting_twins() as twins:
                    ca.reset_launch_count()
                    gn.reset_launch_count()
                    job._sample_stack(images, torch.Generator("cuda").manual_seed(5))
                    torch.cuda.synchronize()
                    launches = {"qkv_attention": ca.launch_count(),
                                "group_norm_act": gn.launch_count()}
                want = {"qkv_attention": 0, "group_norm_act": len(norm_seen)}
                want_twins = {"qkv_attention": len(attn_seen), "group_norm_act": 0}
                log(f"{label}: GroupNorm sites {sorted(set(norm_seen))} (training forward "
                    f"{sorted(set(train_seen))}); attention inputs {sorted(set(attn_seen))}; "
                    f"one inference batch: launches {launches} (expected {want}), twins "
                    f"{dict(twins)} (expected {want_twins}: fp32 attention takes its twin)")
                if launches != want or dict(twins) != want_twins:
                    raise AssertionError(f"{label}: launches {launches} != {want} or twins "
                                         f"{dict(twins)} != {want_twins}")
                counted[f"{au}_{eu}"] = launches
                del job, trainer, state
    finally:
        shutil.rmtree(base, ignore_errors=True)
    yield

    wall, text = run_output(runs, "study")
    report = runs.dir("study") / "work" / "report"
    summary = json.loads((report / "summary.json").read_text())
    figures = summary["artifacts"]["figures"]
    names = {p.name for p in report.iterdir()}
    missing = sorted(STUDY_ARTIFACTS - names) + sorted(
        f for f in STUDY_FIGURES if f not in figures or not Path(figures[f]).is_file())
    checks = summary["checks"]
    shift = checks["ood_auroc"]["per_shift"]["ood_noise"]
    al = checks.get("al_improvement", {})
    walls = summary["walls"]
    log(f"study run: exit 0 in {wall:.1f}s (process included, {BESIDE}); the study's own wall "
        f"{summary['wall_seconds']}s on {summary['environment']['device_name']} "
        f"({smi}); artifacts {sorted(names)}")
    for cell, w in walls["cells"].items():
        log(f"study cell {cell}: train {w['train_s']:.2f}s, infer {w['infer_s']:.2f}s, "
            f"evaluate {w['evaluate_s']:.2f}s")
    log(f"study AL arm {walls['al_s']:.2f}s, report {walls['report_s']:.2f}s; ood_noise "
        f"baseline {shift['softmax_entropy_baseline']}, EU {shift['eu_methods']}; AU NCC "
        f"{checks['ambiguity_ncc']['mean_au_ncc_by_au_type']}; AL {al}")
    if missing or summary["matrix"]["versions"] != 8:
        raise AssertionError(f"study: missing artifacts {missing} or "
                             f"{summary['matrix']['versions']} versions, not 8")
    if not (math.isfinite(shift["softmax_entropy_baseline"]) and al.get(
            "computed_both_directions")):
        raise AssertionError(f"study: baseline {shift['softmax_entropy_baseline']} not finite "
                             f"or the AL arm's directions not both computed: {al}")
    unfinished = [v for v, st in summary["preflight"].items() if st["missing"]]
    if unfinished:
        raise AssertionError(f"study: versions missing after the run: {unfinished}")
    return {"launches": counted["softmax_dropout"], "launches_by_cell": counted,
            "norm_cases": norm_cases, "norm_backward_cases": norm_backward_cases,
            "run_wall_s": wall,
            "study_wall_s": summary["wall_seconds"], "walls": walls}


def training_phases(smi, paths, runs, norm_site_list, launches_by_path, seen_attn, seen_norm,
                    attn_checked168, norm_checked168):
    """The chosen training paths. Each phase is a generator: its timed part
    runs up to its ``yield``, the phases' timed parts one after another with
    nothing else on the card; then the entry-point runs start (``runs``,
    ``ENTRY_JOBS`` at once, the train path's recipe, the longest, first) and
    each phase's rest waits for its own run. Each adds its launches per
    step to ``launches_by_path`` (the train path also its remat step's)."""
    phases = {
        "train_hrnet": lambda: phase_train_hrnet(smi, runs),
        "train_subensemble": lambda: phase_train_subensemble(smi, norm_site_list, seen_attn,
                                                             seen_norm),
        "train_multiclass": lambda: phase_train_multiclass(smi, runs, norm_site_list,
                                                           attn_checked168, norm_checked168),
        "train_swag": lambda: phase_train_swag(smi, runs, norm_site_list, seen_attn, seen_norm),
        "train_ensemble": lambda: phase_train_ensemble(smi, runs, norm_site_list, seen_attn,
                                                       seen_norm),
        **{f"train_{model}": functools.partial(phase_train_family, smi, model, runs)
           for model in TRAIN_FAMILIES},
        "train": lambda: phase_train(smi, norm_site_list, runs),
        "study": lambda: phase_study(smi, runs)}
    started = {}
    for path, phase in phases.items():
        if path in paths:
            started[path] = phase()
            next(started[path])
    if started:
        log(f"timed training phases done; the entry-point runs start ({ENTRY_JOBS} at once)")
        runs.start()
    stats = {}
    for path, gen in started.items():
        try:
            next(gen)
            raise AssertionError(f"{path}: the phase yields more than once")
        except StopIteration as done:
            stats[path] = done.value

    def step_launches(counts):
        return {k: v for k, v in counts.items() if not k.endswith("_vjp")}

    new_stats = {p: st for p, st in stats.items() if p in phases and p != "train"
                 and p[len("train_"):] not in TRAIN_FAMILIES}
    family_stats = {p[len("train_"):]: st for p, st in stats.items()
                    if p[len("train_"):] in TRAIN_FAMILIES}
    new_attn, new_norm = [], []
    for path, st in new_stats.items():
        counts = st["launches"] if "launches" in st else st["step"]["launches"]
        launches_by_path[path] = step_launches(counts)
        served = st.get("serve", {})
        new_attn += served.get("attn_cases", [])
        new_norm += served.get("norm_cases", []) + st.get("norm_cases", [])
    for model, st in family_stats.items():
        launches_by_path[f"train_{model}"] = step_launches(st["step"]["launches"])
    train_stats = stats.get("train")
    if train_stats is not None:
        launches_by_path["train"] = step_launches(train_stats["step"]["launches"])
        launches_by_path["train_remat"] = step_launches(train_stats["remat"]["launches"])
    return train_stats, family_stats, new_stats, new_attn, new_norm


def parse_paths(argv) -> tuple[str, ...]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--paths", default=",".join(PATHS),
                        help=f"comma-separated subset of {', '.join(PATHS)} (default: all)")
    names = [p for p in parser.parse_args(argv).paths.split(",") if p]
    unknown = sorted(set(names) - set(PATHS))
    if unknown or not names:
        parser.error(f"unknown or no paths {unknown}; choose from {', '.join(PATHS)}")
    missing = [str(PATH_ASSETS[p]) for p in names
               if PATH_ASSETS[p] is not None and not PATH_ASSETS[p].is_file()]
    if missing:
        raise FileNotFoundError(f"assets of the chosen paths are missing: {missing}")
    return tuple(p for p in PATHS if p in names)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--multidevice-rank"]:  # one rank of the multidevice path
        sys.path.insert(0, str(REPO))
        return multidevice_rank(Path(argv[1]))
    paths = parse_paths(argv)
    sys.path.insert(0, str(REPO))
    smi = phase_device()
    import torch

    log(f"paths: {', '.join(paths)}")
    ptxas = phase_build()
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import fmt, norm_sites, per_forward
    rows = BATCH * MEMBERS
    rows16 = ("ssn", "prob_unet", "ensemble")
    # unet16 attends at its two deepest levels: HW/4 (C=128) and HW/8 (C=256);
    # the main path's 256-row sites always, the 16-row and 168-row sites with
    # the paths that run them
    attn_cases = [attention_case(rows, t, c, 4, seed=1 + i)
                  for i, (t, (_, c)) in enumerate(UNET16_ATTENTION.items())]
    attn_checked = {(c["B"], c["T"], c["C"]) for c in attn_cases}
    attn_cases16 = [attention_case(BATCH, (HW // div) ** 2, c, 4, seed=600 + i)
                    for i, (div, c) in enumerate(ATTENTION_SITES16)
                    if any(p in paths for p in rows16)]
    attn_checked16 = {(c["B"], c["T"], c["C"]) for c in attn_cases16}
    mc_rows = multiclass_rows()
    multiclass = any(p in paths for p in ("multiclass", "train_multiclass"))
    attn_cases168 = [attention_case(mc_rows, t, c, 4, seed=700 + i)
                     for i, (t, (_, c)) in enumerate(UNET16_ATTENTION.items())
                     if multiclass]
    attn_checked168 = {(c["B"], c["T"], c["C"]) for c in attn_cases168}
    width_cases = attention_width_cases()

    sites = {model: norm_sites(model, HW) for model in ("softmax", "ssn", "prob_unet")}

    def distinct(site_list):
        return sorted(set(site_list), key=lambda s: (-s[0][0], s))

    log("GroupNorm sites of one forward: " + ", ".join(
        f"{model} {len(sl)} ({len(distinct(sl))} distinct (shape, dtype, act))"
        for model, sl in sites.items()))
    # every site's shape in both dtypes (bf16 as the bf16 paths give it, and
    # fp32 at the heads; fp32 as the fp32 paths give it) at the main paths'
    # 256 rows and the batch-1 path's 16; the SSN's and prob-U-Net's at the
    # 16 rows their calls run; at 168 rows the multiclass path's own sites
    groups = [(rows, ("softmax",), ("bfloat16", "float32"))]
    if any(p in paths for p in rows16):
        groups.append((BATCH, ("softmax", "ssn", "prob_unet"), ("bfloat16", "float32")))
    norm_cases = {}
    for n_rows, models, dtypes in groups:
        shape_acts = {(shape, act) for m in models for shape, _, act in sites[m]}
        for shape, act in sorted(shape_acts, key=lambda sa: (-sa[0][0], sa)):
            for dt in dtypes:
                key = ((n_rows,) + shape, dt, act)
                norm_cases[key] = group_norm_case(key[0], dt, act, seed=10 + len(norm_cases))
    if multiclass:
        for shape, dt, act in distinct(sites["softmax"]):
            key = ((mc_rows,) + shape, dt, act)
            norm_cases[key] = group_norm_case(key[0], dt, act, seed=10 + len(norm_cases))
    wide_cases = [group_norm_case((2,) + shape, dt, "silu", seed=500 + i, timed=False)
                  for i, shape in enumerate(WIDE_NORM_SITES) for dt in ("bfloat16", "float32")]
    norm_checked = {((rows,) + shape, dt, act) for shape, dt, act in distinct(sites["softmax"])}
    norm_checked16 = {((BATCH,) + shape, dt, act) for m in ("ssn", "prob_unet")
                      for shape, dt, act in sites[m]}
    norm_checked168 = {((mc_rows,) + shape, dt, act) for shape, dt, act in sites["softmax"]}

    # the main-path launch counts: unet16's 11 attention and 56 GroupNorm
    # sites per forward (the softmax phase checks them)
    attn_calls = {(rows, t, c): n for t, (n, c) in UNET16_ATTENTION.items()}
    norm_seen = [((rows,) + shape, dt, act) for shape, dt, act in sites["softmax"]]
    launches_by_path, img_s = {}, {}
    if "softmax" in paths:
        launches_by_path["softmax"], seen_calls, norm_seen, img_s["softmax"] = phase_main_path(
            attn_checked, norm_checked)
        if seen_calls != attn_calls:
            raise AssertionError(f"softmax attention calls {seen_calls} != {attn_calls}")
    if "diffusion" in paths:
        launches_by_path["diffusion"], img_s["diffusion"] = phase_diffusion(norm_checked)
    generative = {model: phase_generative16(model, attn_checked16, norm_checked16)
                  for model in ("ssn", "prob_unet") if model in paths}
    for model, g in generative.items():
        launches_by_path[model], img_s[model] = g[0], g[3]
    if "ensemble" in paths:
        # the ensemble's members run unet16 forwards at 16 rows, the sites checked above
        norm_checked_ens = {((BATCH,) + shape, dt, act) for shape, dt, act in sites["softmax"]}
        (launches_by_path["ensemble"], ens_attn_calls, ens_norm_seen, img_s["ensemble"],
         ens_overheads) = phase_ensemble(attn_checked16, norm_checked_ens)
    # the folded ensemble and unet256 check the shapes they give the kernels
    # against the twins (beyond those checked above) before their counted calls
    seen_attn, seen_norm = set(attn_checked), set()
    folded = unet256 = None
    if "ensemble_folded" in paths:
        folded = phase_ensemble_folded(smi, seen_attn, seen_norm)
        launches_by_path["ensemble_folded"] = folded["strategies"]["folded"]["launches"]
        for name, st in folded["strategies"].items():
            launches_by_path[f"ensemble_folded_{name}"] = st["launches"]
            img_s[f"ensemble_folded_{name}"] = st["img_s"]
    if "unet256" in paths:
        unet256 = phase_unet256(smi, seen_attn, seen_norm)
        launches_by_path["unet256"], img_s["unet256"] = unet256["launches"], unet256["img_s"]
    new_attn_cases = [c for ph in (folded, unet256) if ph for c in ph["attn_cases"]]
    new_norm_cases = [c for ph in (folded, unet256) if ph for c in ph["norm_cases"]]
    if "hrnet" in paths:
        launches_by_path["hrnet"], img_s["hrnet"], hrnet_eu = phase_hrnet()
    if "multiclass" in paths:
        (launches_by_path["multiclass"], mc_attn_calls, mc_norm_seen,
         frames_s) = phase_multiclass(attn_checked168, norm_checked168)
    if "infer" in paths:
        launches_by_path["infer"], infer_stats = phase_infer(smi, attn_checked, norm_checked)
    if "eval" in paths:
        launches_by_path["eval"], eval_stats = phase_eval(smi, attn_checked, norm_checked)
    if "lidc_import" in paths:
        launches_by_path["lidc_import"], lidc_stats, lidc_cases = phase_lidc_import(
            smi, attn_checked, norm_checked)
        new_attn_cases += lidc_cases[0]
        new_norm_cases += lidc_cases[1]
    if "multidevice" in paths:
        md_launches, multidevice_stats = phase_multidevice(smi, attn_checked, norm_checked)
        launches_by_path.update(md_launches)
        new_attn_cases += multidevice_stats.pop("attn_cases", [])
        new_norm_cases += multidevice_stats.pop("norm_cases", [])
    if "retina" in paths:
        launches_by_path["retina"], retina_stats, retina_cases = phase_retina(
            smi, attn_checked, norm_checked)
        new_attn_cases += retina_cases[0]
        new_norm_cases += retina_cases[1]
    runs = None
    if any(p.startswith("train") or p == "study" for p in paths):
        import tempfile

        from diffuncertainty_tpu_torch.tools.train_recipe import Runs

        # queued now; they start once the training phases' timed parts are done
        runs = Runs(Path(tempfile.mkdtemp(prefix="chip_smoke_runs_")), ENTRY_JOBS)
        register_entry_runs(runs, paths)
    try:
        (train_stats, family_stats, new_stats, new_attn, new_norm) = training_phases(
            smi, paths, runs, sites["softmax"], launches_by_path, seen_attn, seen_norm,
            attn_checked168, norm_checked168)
    finally:
        if runs is not None:
            runs.stop()
            shutil.rmtree(runs.base, ignore_errors=True)
    new_attn_cases += new_attn
    new_norm_cases += new_norm
    quality = phase_quality(paths)
    if "multiclass" in paths:
        quality["multiclass_bf16"] = phase_multiclass_quality()

    # one entry per kernel; times are for the work of one main-path forward
    def attn_sum(cases, calls):
        return {k: sum(calls.get((c["B"], c["T"], c["C"]), 0) * c[k] for c in cases)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}

    def calls_text(calls):
        return ", ".join(f"{n} calls at B={b} T={t} C={c}" for (b, t, c), n in sorted(calls.items()))

    attn_per = attn_sum(attn_cases, attn_calls)
    bound_by = max(attn_cases,
                   key=lambda c: attn_calls[(c["B"], c["T"], c["C"])] * c["bound_ms"])
    attn_extra = {f"{model}_forward16": dict(attn_sum(attn_cases16, g[1]), per=(
        f"one {BATCH}-row {model} call: " + calls_text(g[1])))
        for model, g in generative.items()}
    # GroupNorm per forward at 256 rows (the main paths) and at 16 (batch-1,
    # and the SSN's and prob-U-Net's calls)
    norm_keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_bytes_ms",
                 "bound_ops_ms")

    def norm_sum(seen, n_rows):
        return {k: per_forward([dict(norm_cases[((n_rows,) + shape[1:], dt, act)], calls=1)
                                for shape, dt, act in seen], k) for k in norm_keys}

    norm_per = norm_sum(norm_seen, rows)
    norm_extra = {f"{model}_forward16": dict(norm_sum(g[2], BATCH), per=(
        f"one {BATCH}-row {model} call: its {len(g[2])} GroupNorm sites"))
        for model, g in generative.items()}
    if any(p in paths for p in rows16):
        norm_extra["rows16"] = dict(norm_sum(norm_seen, BATCH),
                                    per=f"one {BATCH}-row unet16 forward (the batch-1 path)")
    if "ensemble" in paths:
        ens_per = f"one ensemble call: {MEMBERS} member forwards of {BATCH} rows"
        attn_extra["ensemble_call"] = dict(attn_sum(attn_cases16, ens_attn_calls), per=ens_per)
        norm_extra["ensemble_call"] = dict(norm_sum(ens_norm_seen, BATCH), per=ens_per)
    if "multiclass" in paths:
        # one member forward of the multiclass call (a call is MC_MEMBERS of them)
        mc_attn_forward = {k: n // MC_MEMBERS for k, n in mc_attn_calls.items()}
        mc_per = (f"one {mc_rows}-row member forward of the multiclass call (a call is "
                  f"{MC_MEMBERS}): ")
        attn_extra["multiclass_forward168"] = dict(attn_sum(attn_cases168, mc_attn_forward),
                                                   per=mc_per + calls_text(mc_attn_forward))
        norm_extra["multiclass_forward168"] = dict(
            norm_sum(mc_norm_seen[:len(mc_norm_seen) // MC_MEMBERS], mc_rows),
            per=mc_per + f"its {len(mc_norm_seen) // MC_MEMBERS} GroupNorm sites")
    log(f"GroupNorm per {rows}-row forward: device {fmt(norm_per['device_ms'])} (events "
        f"{fmt(norm_per['ms'])}), bound {fmt(norm_per['bound_ms'])}, F.group_norm "
        f"{fmt(norm_per['library_ms'])}")
    for key in norm_extra:
        n = norm_extra[key]
        a = attn_extra.get(key)
        attn_text = "" if a is None else (
            f"attention kernel {a['ms']:.4f} ms, sdpa {a['library_ms']:.4f} ms, bound "
            f"{a['bound_ms']:.4f} ms; ")
        log(f"{key}: {attn_text}GroupNorm device {fmt(n['device_ms'])} (events "
            f"{fmt(n['ms'])}), F.group_norm {fmt(n['library_ms'])}, bound {fmt(n['bound_ms'])}")
    # each backward kernel per training step at batch 16: its calls at every
    # site (CUDA events, each site alone) beside the twin VJP's, the plain
    # version's, the library backward's and the bound
    step_stats = ({"train": train_stats} if "train" in paths else {}) | {
        f"train_{m}": st for m, st in family_stats.items()}
    backward_per_step = {"attention": {}, "norm": {}}
    for path, st in step_stats.items():
        for key, cases in (("attention", st["attention_backward"]),
                           ("norm", st["group_norm_backward"])):
            per_step = {k: per_forward(cases, k) for k in ("ms", "device_ms", "vjp_ms",
                                                           "plain_ms", "library_ms", "bound_ms")}
            per_step["device_kernels"] = sorted({c["device_kernels"] for c in cases},
                                                key=lambda n: -1 if n is None else n)
            per_step["bound_by"] = max(cases, key=lambda c: c["calls"] * c["bound_ms"])["bound_by"]
            per_step["per"] = (f"one bf16 {path} step at batch {BATCH}: the backward kernel at "
                               f"each of its sites, each alone (CUDA events; device time from "
                               f"torch.profiler), beside the twin's VJP, the plain version, the "
                               f"library's backward and the bound")
            backward_per_step[key][path] = per_step
            log(f"{key} backward per {path} step on {smi}: kernel {per_step['ms']:.3f} ms (device "
                f"{fmt(per_step['device_ms'])}, {per_step['device_kernels']} device kernels a "
                f"call), twin VJPs {per_step['vjp_ms']:.3f} ms, plain "
                f"{per_step['plain_ms']:.3f} ms, library backward {per_step['library_ms']:.3f} "
                f"ms, bound {per_step['bound_ms']:.4f} ms "
                f"({per_step['bound_by']})")
    # the main path: softmax, else the chosen path that launches the kernels most
    main_path = "softmax" if "softmax" in paths else max(
        launches_by_path, key=lambda p: sum(launches_by_path[p].values()))

    def launches(kernel):
        return {"launches": launches_by_path.get(main_path, {}).get(kernel, 0),
                "launches_path": main_path,
                "launches_by_path": {f"{p}_call": counts[kernel]
                                     for p, counts in launches_by_path.items()}}

    kernels = [{
        "name": "qkv_attention",
        "route": "cuda",
        "source": "diffuncertainty_tpu_torch/csrc/qkv_attention.cu",
        "replaces": "diffuncertainty_tpu/ops/pallas_attention.py:38",
        **launches("qkv_attention"),
        "max_abs_err": max(c["max_abs_err"] for c in attn_cases + attn_cases16 + attn_cases168
                           + width_cases + new_attn_cases),
        "ms": attn_per["ms"],
        "plain_ms": attn_per["plain_ms"],
        "bound_ms": attn_per["bound_ms"],
        "bound_by": bound_by["bound_by"],
        "library_ms": attn_per["library_ms"],
        "per": f"one {rows}-row unet16 forward (one softmax-path call; a diffusion call is "
               f"{DDIM_STEPS}): " + calls_text(attn_calls),
        **attn_extra,
        "shapes": attn_cases,
        "shapes16": attn_cases16,
        "shapes168": attn_cases168,
        "other_widths": width_cases,
        "folded_and_unet256_shapes": new_attn_cases,
        "ptxas": ptxas.get("qkv_attention", {}),
    }, {
        "name": "group_norm_act",
        "route": "cuda",
        "source": "diffuncertainty_tpu_torch/csrc/group_norm_act.cu",
        "replaces": "diffuncertainty_tpu/ops/pallas_groupnorm.py:32",
        **launches("group_norm_act"),
        "max_abs_err": max(c["max_abs_err"] for c in list(norm_cases.values()) + wide_cases
                           + new_norm_cases),
        "ms": norm_per["ms"],
        "device_ms": norm_per["device_ms"],
        "plain_ms": norm_per["plain_ms"],
        "bound_ms": norm_per["bound_ms"],
        "bound_by": ("bytes" if norm_per["bound_bytes_ms"] >= norm_per["bound_ops_ms"]
                     else "operations"),
        "library_ms": norm_per["library_ms"],
        "per": f"one {rows}-row unet16 forward: its {len(norm_seen)} GroupNorm sites at the "
               f"bf16 path's shapes and dtypes; a diffusion call is {DDIM_STEPS} forwards",
        "per_diffusion_call": {k: None if v is None else DDIM_STEPS * v
                               for k, v in norm_per.items()},
        **norm_extra,
        "shapes": list(norm_cases.values()),
        "wide_shapes": wide_cases,
        "folded_and_unet256_shapes": new_norm_cases,
        "ptxas": ptxas.get("group_norm_act", {}),
    }]
    # the backward kernels: the main path is the train path's step (else the
    # first family step that ran); launches are that step's
    backward_path = next((p for p in ("train", "train_diffusion", "train_ssn",
                                      "train_prob_unet") if p in step_stats), None)
    if backward_path is None:
        log("no training step ran: the backward kernels are not in this run's kernels line")
    else:
        norm_bwd_extra = [c for st in new_stats.values()
                          for c in st.get("norm_backward_cases", [])]
        for name, kernel, key, replaces, note in (
                ("qkv_attention_backward", "qkv_attention", "attention",
                 "diffuncertainty_tpu/ops/pallas_attention.py:95",
                 "the custom_vjp backward of the TPU kernel at :38, which differentiates its "
                 "XLA twin"),
                ("group_norm_act_backward", "group_norm_act", "norm",
                 "diffuncertainty_tpu/ops/norm.py:19",
                 "no TPU kernel: the JAX package trains on XLA's autodiff of group_norm_32; "
                 "the Pallas kernel at pallas_groupnorm.py:32 has no backward")):
            per = backward_per_step[key]
            cases = [c for st in step_stats.values()
                     for c in st["attention_backward" if key == "attention"
                                 else "group_norm_backward"]]
            cases += [] if key == "attention" else norm_bwd_extra
            main = per[backward_path]
            kernels.append({
                "name": name,
                "route": "cuda",
                "source": f"diffuncertainty_tpu_torch/csrc/{kernel}.cu",
                "replaces": replaces,
                "replaces_note": note,
                "launches": launches_by_path[backward_path][f"{kernel}_bwd"],
                "launches_path": backward_path,
                "launches_by_path": {f"{p}_step": counts[f"{kernel}_bwd"]
                                     for p, counts in launches_by_path.items()
                                     if f"{kernel}_bwd" in counts},
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "max_abs_err_plain": max(c["max_abs_err_plain"] for c in cases),
                "ms": main["ms"],
                "device_ms": main["device_ms"],
                "device_kernels_a_call": main["device_kernels"],
                "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": main["library_ms"],
                "twin_vjp_ms": main["vjp_ms"],
                "per": main["per"],
                **{f"{p}_step": v for p, v in per.items()},
                "shapes": cases,
            })
    extra = ""
    if "ensemble" in paths:
        extra += f" (ensemble member overheads {ens_overheads})"
    if folded:
        extra += "; ensemble_folded " + ", ".join(
            f"{k} {v['ms']:.2f} ms (busy {v['busy_share']}, peak {v['peak_memory_gib']:.2f} GiB)"
            for k, v in folded["strategies"].items()) + (
            f", fastest {folded['fastest']}, auto "
            f"{folded['auto']}, fp32 {folded['fp32']}")
    if unet256:
        extra += (f"; unet256 {unet256['ms']:.2f} ms, peak {unet256['peak_memory_gib']:.2f} GiB, "
                  f"twin call {unet256['twin_call']}")
    if "hrnet" in paths:
        extra += f"; hrnet mean EU {hrnet_eu:.4e}"
    if "multiclass" in paths:
        extra += f"; multiclass path {frames_s:.3f} frames/s"
    if "infer" in paths:
        extra += f"; infer job {infer_stats}"
    if "eval" in paths:
        extra += "; eval " + json.dumps(eval_stats)
    if "lidc_import" in paths:
        extra += "; lidc_import " + json.dumps(lidc_stats)
    if "multidevice" in paths:
        extra += "; multidevice " + json.dumps(multidevice_stats)
    if "retina" in paths:
        extra += "; retina " + json.dumps(retina_stats)
    if "train" in paths:
        extra += (f"; train step {train_stats['step']['split']}, remat {train_stats['remat']}, "
                  f"recipe {train_stats['recipe']}, trained quality on 32 images "
                  f"{train_stats['quality_32']}, on 256 {train_stats['quality']}")
    for path, st in new_stats.items():
        extra += f"; {path} " + json.dumps({k: v for k, v in st.items() if k not in (
            "attn_cases", "norm_cases", "norm_backward_cases")}, default=str)
    for model, st in family_stats.items():
        extra += (f"; train_{model} step {st['step']['split']}, run {st['run']['wall_s']:.1f}s, "
                  f"serving launches {st['serve_launches']}, infer {st['infer']}")
    log(", ".join(f"{p} path {v:.3f} img/s" for p, v in img_s.items()) + extra
        + f"; quality {quality}")
    log(f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
