#!/usr/bin/env python3
'''Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0] [--model-dir benchmarks/bench_model_fast160]

Phases 1-4j drive ``--model-dir`` (the shipping fast160 model); phase 4k
drives the faithful model, the ``bench_model`` folder beside it.

Phases, each printed with its elapsed seconds as it starts:

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels (nvcc, one process per build unit, then
   ctypes), started in a thread as the script starts so that it runs while
   torch imports;
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes: ROIAlign at batch 16 for the box (out 7, K 16), mask
   (out 14, K 1) and keypoint (out 7, K 1) stages, to 2 bf16 ulps (the
   distance in bf16 steps printed: both round the weights and the
   intermediate T to bf16); the
   frame clean on (64, 160, 160) uint8, bit-exact. Times are device time
   per call from a ``torch.profiler`` trace of 20 calls (and, in the
   phase lines, the median CUDA-event time around single calls, which
   includes the host's launch time; ROIAlign also through its registered
   op, ``m2de::roi_align_bf16``, which the path calls), beside each
   kernel's bound (the larger
   of its bytes over 3.35 TB/s and the operations of a minimal form of its
   function over the card's rate for them: 67e12 fp32 operations per second
   for ROIAlign, 66.9e12 two-input min/max for the clean) and the plain
   version's time, with each kernel's launch plan. The ROIAlign entry of the
   report sums its three stage calls, one batch's pooling. No single PyTorch
   call computes either function (torchvision is absent), so there is no
   library time;
3b. the ROIAlign stage-2 experiment's path: its entry,
   ``benchmarks.roi_stage2_exp.main`` (a check of every variant at a small
   shape, then CUDA-event times at its shape, 64 images x 256 ROIs, canvas
   256, C 256, at block_k 8 and 16, beside ``roi_align_cuda`` and the
   two-call cuBLAS form), with the four stage-2 kernels' launch counts set
   to 0 just before and read just after; then each of the four kernels, and
   noxpose with a bf16 output, against its plain version at the main path's
   box shape (B 16, K 16, canvas 160) and at the experiment's shape on its
   first 4 images (the plain version's f32 T at 64 would take 7.5 GB), to 2
   bf16 ulps, with each kernel's launch plan (all four run one loop; its
   channels per block, held against the C launcher's), each kernel beside
   its twin on that loop (transpose beside retile, dotswap beside noxpose:
   the same mma, another B load or epilogue), its device time at the box
   shape beside its bound (the same yardstick as ROIAlign's, the output
   counted in its own dtype), the dense form's tensor-core time (its
   multiply-adds x 2 over 989e12/s), the two-call form's time, and the mma
   each kernel issued (``roi_stage2_kernel.mma_count``) over its time, at
   both shapes;
3c. the NMS kernel (``csrc/nms.cu``, through ``ops/nms.py:nms_keep_mask``)
   at the main path's three shapes, on candidates made as the RPN makes
   them (``synthetic.proposal_pool``): the faithful model's proposal NMS
   (B 50, K 3,008, level-shifted), its train proposal NMS (B 8, K 5,008)
   and its box head's NMS (B 50, K 1,000). Each keep mask equal bit for bit
   to the plain fixpoint's on the same card tensors, one launch a call and
   no host sync; CUDA-event time of back-to-back calls (kernel and plain)
   beside the bound, the larger of the fp32 IoU operations of the distinct
   pairs (12 a pair, B x K (K - 1) / 2) over 67e12/s and the bytes in and
   out (22 a box) over 3.35 TB/s; each shape's launch plan and how many of
   its clusters the card holds at once;
4. the main path: ``Predictor.from_model_dir`` on the committed fast160
   model (R50-FPN, full width, weights read from its npz), a chunk of 64
   sentinel-encoded 424x512 frames made from ``--seed``, and
   ``extract.process_chunk`` with the kernels' launch counts set to 0 just
   before and read just after (and whether the FPN levels reach the pool
   as NHWC bf16, which decides whether its NHWC view copies); then 5 timed
   chunks (median wall time of
   each stage and of the chunk, host clock, each stage ended by a
   synchronize) and one chunk under ``torch.profiler`` (the device's busy
   share of its wall time, the copy kernels and the top kernels by device
   time); then the
   same 4-frame input through the port on the card and on the CPU (plain
   versions, f32 model) as a reference check;
4b. the session path: ``synthetic.write_raw_session`` writes a raw session
   of 1,100 Kinect-size frames (424x512, 477 MB) into a temporary directory
   (deleted at the end); ``Session`` and ``extract.prepare_session`` find
   its background, ROI and true depth on the card with the extract CLI's
   defaults (the wall time printed; the session's floor is tilted and
   rough); ``extract.extract_chunks`` runs its chunks of 1000 (the tail of
   100 padded to 1000) through the fast160 predictor, the host brain and the
   output ops to ``fetch_results``, with both kernels' launch counts set to
   0 just before and read just after (3 ROIAlign launches per detection
   batch, 1 clean per chunk), printing per chunk the host's read+prep ms,
   ``process_chunk``'s ms, ``process_features``' (the brain's moments
   pull, EM init, ``smooth_update``, flip votes and angle filter from its
   timers; the rest is the output ops with the device) and
   ``fetch_results``' (each ended by a synchronize), then the session's
   frames/s from disk through ``fetch_results`` beside the figure up to
   ``process_chunk``, the detections and peak device memory, and checks
   each chunk's fetched results (shapes, dtypes, finite features); then
   the output ops on the card against the CPU on chunk 0's inputs (the
   crops in f32 to 1e-3 and in uint8 equal but at .5 edges, the masks
   and packed masks equal but at 0.5 edges, z, area and the 17 scalars and
   keypoint dict equal, heights to 1e-5) and each op's device ms; the
   session once more with ``pad_chunks`` False (frames/s, and the largest
   difference of the smoothed centroid and orientation over the last true
   frames against the padded run); the Kalman smoother backends on the
   host (numpy and the C++ core at the point tracker's size, S 54, O 18,
   T 1000, 5% of the rows missing, median ms of 5, held to each other to
   1e-9, and the backend the port picks) and the angle filter's ms per 1000
   frames; a session of 400 frames whose first 60 have no mouse, through
   the whole path in chunks of 200 (missing rows; the trackers must end
   finite); then ``prepare_session`` once more on the card under cProfile
   (its wall time warm, and the host functions that take it), and on the
   CPU, which must give the same ROI, background and true depth and the
   plane (unit normal to 1e-5, d to 1e-3 mm); ``get_roi`` on the card and
   on the CPU on ``synthetic.rough_arena`` backgrounds of 424x512, where the
   RANSAC's accept rule weighs near hypotheses, must agree in the same way;
   then chunk 0 once more: one read of its raw frames and the C++ host
   prep, which must equal its plain numpy version bit for bit;
4c. the ``extract`` command (``cli.main`` in this process, ``--model``
   the fast160 directory, the CLI's defaults: batch 10, chunks of 1000),
   with both kernels' launch counts set to 0 just before and read just
   after each run, on (a) phase 4b's session: the status must say
   ``complete: true``; ``results_00.h5``, read back with the port's reader,
   is held against phase 4b's serial ``extract_chunks`` results dataset by
   dataset (the frames that differ printed per dataset); the CLI runs again
   with cuDNN's deterministic algorithms (its results are kept for phase
   4h (b)), and where any dataset differed, chunk 0 runs twice through
   ``process_chunk`` with cuDNN's default and deterministic algorithms, and
   the deterministic run's file must equal a serial run at the CLI's batch
   size bit for bit; its timestamps, true depth, ROI, background and first
   frame against ``prepare_session``'s; the keypoints TSV's rows and the
   instance log's frames; and (b) a session of 4,000 frames (1.74 GB, written and deleted
   here): the overall frames/s that ``extract_session`` logs, each stage's
   ``busy_s``, ``cpu_s`` and chunks from the status file's ``stage_stats``,
   the peak device memory, the file's size against its uncompressed bytes,
   and the serial ``extract_chunks`` frames/s on the same session. Each run
   also writes the preview, ``results_00.avi`` (Motion-JPEG, drawn by the
   C++ core ``csrc/draw_host.cpp`` and encoded by ``csrc/mjpeg_host.cpp``,
   both built with g++ from the checkout): its index must hold exactly the
   session's frames, each a well-formed JPEG (SOI, a SOF0 of the video's
   size, EOI); its size, and the ``Preview Video`` and ``Preview Encode``
   stages' ``busy_s`` and ``cpu_s`` per 1,000 frames with the render's
   ``sub_times``, are printed;
4d. training (no kernel of its own: the training path reaches no
   ``pallas_call`` in the JAX package): (a) a Label Studio export of 48
   synthetic 150x150 ``_depth.png`` views (``synthetic.write_annotated_views``,
   written with the port's PNG writer) and ``cli.main(['train', ...])`` on
   the fast160 config (R50-FPN, full width, bf16, batch 8) with only
   ``warmup_iters``, ``eval_period`` and ``checkpoint_period`` shortened
   (each change printed), 60 steps from random weights: every logged loss
   finite, the mean ``total_loss`` of the last 10 steps below the first
   10's, the checkpoints and ``last_checkpoint`` written; then ``--resume
   --max-iter 70``, which must continue at step 61; iterations/s and
   images/s (median after step 5), peak device memory, the first and last
   loss terms; (b) 5 synchronised steps split into augment, forward and
   losses (inside it the gather ROIAlign's 3 calls and the train proposal
   NMS, each timed apart with a synchronize around it), backward and the
   optimizer, the NMS host syncs per step, then one step under
   ``torch.profiler`` (CUDA activity only): the device's busy share, the
   launches and the top kernels; (c) the tiny model of the CPU tests (f32,
   TF32 off) on one fixed batch and one fixed set of draws, card against
   CPU: every loss term and every gradient to 1e-3, and one augmented batch;
   (d) the trained weights written as ``params_f16.npz`` by
   ``save_params_npz`` and loaded by ``Predictor.from_model_dir``, run on 16
   views (the ROIAlign kernel's launches counted: 3 per batch of 8);
4e. the model lifecycle, through ``cli`` (phase 4d's views, config and
   trained model and phase 4b's session kept for it): (a) a Detectron2
   ``keypoint_rcnn_R_50_FPN_3x`` checkpoint made from ``--seed`` with numpy
   at the zoo's names and shapes (an FPN without norms, whose convs carry
   biases; person and background logits; 17 COCO keypoints; no mask head)
   written as a ``.pkl`` and converted by ``convert-weights`` onto the
   fast160 config: the report's four counts, equal to the CPU converter's
   on the same file and to what the names give, then ``train
   --init-weights`` for 10 steps on the 48 views, every loss finite; (b)
   ``evaluate`` of phase 4d's model on the views' test split on the card
   and with ``--device cpu``, in the model's bf16 and in f32 (a copy of
   the model dir whose config says ``amp_dtype: float32``), every metric
   in range; for each dtype the AP difference, the card's and the CPU's top
   detection per view (box IoU, score difference), and the decisions the
   AP is computed from that differ (``decisions_differ``) are printed. In
   f32 the card is held to the CPU: the same valid detections, boxes to
   1 px and scores to 1e-2 (as in the reference check), and every metric
   equal unless a decision differs. In bf16 the two are not held to each
   other: on a model trained 70 steps, bf16 rounding in other orders moves
   a detection's IoU across a threshold, and one view's top detection
   crossing one threshold moves AP75 of 5 views by 35.8 points; (c)
   ``compile-model`` at batch 10 and canvas 160 (``torch.export``): the
   export's wall time and ``model.pt2``'s size, the loaded program on 10
   views against the live Predictor bit for bit with
   ``cudnn.deterministic``, the ROIAlign kernel launched 3 times by the
   program's batch, and the post-export evaluation equal to the live one;
   (d) ``infer-dataset`` on the 48 views: ms per image, the polygons and
   keypoints written; (e) ``find-roi`` on phase 4b's session, whose ROI,
   background and true depth must equal ``prepare_session``'s. The ROIAlign
   launches of the phase are counted from 0 and must equal 3 per image
   evaluated or pre-annotated on the card and per program batch;
4f. the preview commands: ``visualize-raw`` on phase 4b's session and
   ``visualize-result`` on phase 4c (a)'s results file (kept for it), each
   timed (seconds, frames/s), each AVI's index holding every frame as a
   well-formed JPEG; and ``ops/warp.py:reverse_crop_and_rotate_frames`` on
   the card against the CPU on the results file's first 200 crops (max abs
   error, to 1e-3);
4g. the result upkeep, through ``cli``, on phase 4c (b)'s 4,000-frame
   results file (kept for it), each step timed: ``find-outliers``, whose
   three reports must equal a numpy recomputation from the file;
   ``trim-result --start 100 --stop 1100``, after which every trimmed
   dataset must equal rows 100-1099 of the backup and the metadata be
   untouched; ``manual-flip`` twice with the same ranges, which must give
   back the frames, masks and flips bit for bit and keep ``flips_1`` and
   ``flips_2``; ``verify-flips`` (exit code 0, then 1 on overlapping
   ranges); ``generate-extract-config``, whose YAML the ``--config-file``
   path must read back to the defaults; ``dataset-info`` on phase 4d's
   views; ``system-info``, which must name the card; and ``extract
   --report-outliers`` on 300 frames of phase 4b's session (``--frame-trim
   0 800``), whose reports must equal numpy's;
4h. compressed depth and dataset generation, through ``cli``: (a)
   ``convert-raw-to-avi`` on phase 4b's session (its verify pass reads every
   chunk back bit for bit), with the encode's and the verify decode's
   frames/s, the slice and thread counts and the AVI's bytes against the
   raw file's; then the committed libavcodec fixture
   (``tests/data/ffv1_libavcodec_130x106.avi``), decoded by the port, held
   bit for bit against its frames rebuilt from their seed
   (``synthetic.codec_fixture_frames``); (b) ``extract`` with the CLI's
   defaults on the ``.avi`` with ``cudnn.deterministic``, the kernels'
   launch counts set to 0 just before and read just after: its
   ``results_00.h5`` must hold the same datasets (all but the file names
   and the run's uuid) as phase 4c (a)'s deterministic run on the ``.dat``,
   and the two runs' frames/s are printed side by side; (c)
   ``generate-dataset --sample-method kmeans --num-samples 50`` on the
   ``.dat`` and the ``.avi`` session, whose picks must be the same, and the
   k-means run once more on the CPU on the card's data
   (``dataset.kmeans_features``), whose picks must equal the card's or cost
   within 1% of them (the line says which); ``uniform`` and ``list`` timed;
4i. the last slice: (a) the data-parallel step at world 1 over NCCL against
   the Trainer's step; (b) ``extract --device-input prescaled``; (c)
   ``extract-batch``, printed and two sessions at once; (d) the off-path
   ops card against CPU;
4j. the functions ported last, each on CUDA tensors against the CPU on the
   same inputs, one line each with its seconds: ``find_invalid_pixels`` on
   16 raw 424x512 frames (equal); ``topk_after_nms`` on fast160's 16
   post-NMS candidates with k 1 and on 1,000 tied candidates with k 100
   (equal); ``roi_align_level`` on fast160's P2 level (40 x 40 x 256 f32,
   stride 4) with 16 boxes (to 1e-5 absolute: the same f32 gather on both
   devices, summed in another order on the card); ``augment_sample`` on
   one CUDA draw of ``draw_augment`` at 160 x 160 against the CPU on that
   draw (image to 1e-4 of its largest value, at most 2 pixels beyond, as
   the JAX comparison of ``tests/test_torch_augment.py`` holds it; masks,
   boxes, validity and keypoint visibility equal; keypoints to 1e-4); and
   ``visualize_inference`` on the first frame of phase 4's chunk where the
   mouse was found, with the card's prediction of the phase's model. The
   drawing is host code (the function pulls every tensor to the host before
   it draws), so this checks only the hand-off of a card prediction (its
   CUDA tensors give the drawing of the same prediction as numpy arrays)
   and that something was drawn over the frame;
4k. the faithful model (``bench_model`` beside ``--model-dir``: canvas 256,
   frames scaled to 240-250 px, 1,000 proposals a level into an NMS pool of
   1,024, 256 proposals an image after it): (a) ROIAlign at its three
   stages on the 256 canvas, batch 16 (box: out 7, K 256, 4,096 ROIs;
   mask: out 14, K 1; keypoint: out 7, K 1; boxes drawn as phase 3's and
   scaled by 256 / 160), each held to its plain version by phase 3's rule,
   with its launch plan, device ms over 20 calls, bound and share of it,
   and the card's clocks, power and temperature before and after;
   (b) ``Predictor.from_model_dir`` at batch 16 and phase 4's chunk through
   ``process_chunk`` with the launch counts and ``ops.nms.sync_count`` set
   to 0 just before and read just after (3 ROIAlign and 2 NMS launches a
   batch, 1 clean, no NMS host sync), phase 4's checks
   of the output, the median stage ms of 5 chunks, the chunk's frames/s and
   peak memory, one profiled chunk; (c) phase 4's reference check on its
   first 4 frames (``valid`` and ``keep`` equal, boxes within 1 px, scores
   within 1e-2, cleaned windows equal where the origins agree; the largest
   keypoint difference printed); (d) ``extract`` through ``cli.main`` on
   phase 4b's 1,100-frame session with the CLI's defaults (batch 10, the
   preview written): ``complete: true``, 600 ROIAlign and 2 clean launches,
   frames/s, ``stage_stats`` and the file's size; then again with cuDNN's
   deterministic algorithms, whose datasets must equal a serial
   ``extract_chunks`` run of the faithful predictor at the CLI's batch size
   (also deterministic) bit for bit (the first run's file against it is
   printed: cuDNN's default algorithms move keypoint scores run to run);
   (e) phase 4d (b)'s 5 split train steps at the faithful train shapes
   (canvas 256, 240-250 px views, 2,000 proposals a level and 1,500 after
   an NMS with no cap, batch 8) from its weights on phase 4d's views: it/s,
   the train NMS's ms and host syncs a step, the gather ROIAlign's ms, peak
   memory; every loss finite (no CPU comparison: 4d (c) holds the training
   code);
5. a JSON line of the kernels (ROIAlign, clean and the four stage-2
   kernels; a stage-2 kernel's ``ms``, ``plain_ms`` and ``bound_ms`` are at
   the box shape with block_k 8, its ``launches`` those of phase 3b's
   experiment run; ROIAlign's and the clean's ``launches`` those of phase
   4's chunk, ``session_launches`` those of phase 4b and
   ``extract_launches`` those of phase 4c (a), ``train_export_launches``
   those of phase 4d (d), ``lifecycle_launches`` those of phase 4e,
   ``avi_extract_launches`` those of phase 4h (b)'s ``.avi`` run;
   ROIAlign's ``op_ms`` its device time through the registered op (``ms``
   is the direct launch's), ``max_ulps`` and
   ``one_ulp`` its distance from the plain version in bf16 steps; under
   ``faithful``, phase 4k's launches, ROIAlign's device ms, plain ms and
   bound for one faithful batch and per stage), the whole smoke's wall
   time, then the result line.

It exits non-zero, without a result line, when CUDA is unavailable, when
the port's package is not beside it, or when any phase fails.
'''
import argparse
import cProfile
import functools
import json
import os
import pstats
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
PKG = 'moseq2_detectron_extract_tpu_torch'
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
# H100 SXM fp32 rate outside the tensor cores (an FMA counts 2): ROIAlign.
FP32_OPS_PER_S = 67e12
# Two-input min/max per second for the clean: the card's widest min/max is
# VIMNMX3.U16x2 (cuobjdump of csrc/clean.cu's build), two 16-bit lanes of a
# three-input min or max, i.e. 4 two-input min/max, taken to issue at the
# 32-bit integer min/max rate of 64 per SM per clock: 4 * 64 * 132 SMs *
# 1.98 GHz. (Not measured on the card; a kernel faster than this bound
# would say the rate is higher.)
MINMAX_PER_S = 4 * 64 * 132 * 1.98e9
BF16_TOL = 2.0 ** -6               # 2 bf16 ulps, relative and absolute
# At most 16 taps per output element (4 samples x 4 bilinear taps, the
# weights per ROI and shared by the channels): 16 multiply-adds.
ROI_OPS_PER_OUTPUT = 32
TC_BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate
STAGE2_REPS = 5                    # timed calls per variant at the experiment's shape
STAGE2_BLOCK_K = 8                 # block_k of the comparisons and the box-shape times
STAGE2_WINDOWS = 7                 # alternating windows of each redesigned kernel and its twin
# Min/max operations per pixel of a minimal form of the clean (the form is
# checked against the plain version in tests/test_torch_clean.py):
# the median, 18 (sort each vertical triple, 6; then med3 of the max of the
# lows, the med3 of the mids and the min of the highs of the 3 neighbouring
# columns, 2 + 4 + 2 + 4), and 12 for each of the 3 erosions and 3 dilations
# (row extrema of widths 7 and 9 by doubling, 5; the ellipse's 9 rows,
# sharing the pairs of equal rows, 7).
CLEAN_OPS_PER_PIXEL = 18 + 6 * 12
FRAMES = 64                        # frames per chunk
BATCH = 16                         # frames per detection batch
REPS = 20                          # timed calls per kernel measurement
CHUNKS = 5                         # timed chunks of the main path
SESSION_FRAMES = 1100              # frames of the raw session of phase 4b
SESSION_CHUNK = 1000               # the extract CLI's chunk_size
LONG_SESSION_FRAMES = 4000         # phase 4c (b): 4 chunks of 1000, no tail
LONG_RESULTS = 'results_4c_long.h5'  # phase 4c (b)'s results, kept for phase 4g
ABSENT_SESSION = 400               # frames of the session with the mouse away at first
ABSENT_FRAMES = 60                 # its leading frames without the mouse
ABSENT_CHUNK = 200                 # its chunk size: two chunks, the first with missing rows
PLANE_TOL = (1e-5, 1e-3)           # card vs CPU RANSAC plane: unit normal, d in mm
ROUGH_SEEDS = (0, 1, 2)            # rough_arena backgrounds held card against CPU
FIND_ROI_TOP = 8                   # functions printed from find_roi's host profile
TOP_KERNELS = 12                   # kernel names printed from the profiled chunk
RATES = {}                         # rates a later phase prints beside its own


def phase(msg: str) -> None:
    print(f'[{time.perf_counter() - T0:8.2f}s] {msg}', flush=True)


def card_query() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def card_clocks() -> str:
    '''The card's SM and memory clocks, power draw and temperature now
    (nvidia-smi), to print beside a time that may move with them.'''
    out = subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm,clocks.mem,power.draw,'
                          'temperature.gpu', '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def wall_ms(fn, reps: int) -> float:
    """Median over ``reps`` single calls of CUDA-event time around each call:
    it includes the host's launch time wherever the device waits for it."""
    import torch
    fn()
    torch.cuda.synchronize()
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


def device_ms(fn, reps: int, attempts: int = 3) -> float:
    """Device time per call: the CUDA kernels that ``reps`` calls launched,
    summed from a ``torch.profiler`` trace, over ``reps``. A trace that
    records no device time (it happens now and then) is taken again; after
    ``attempts`` such traces the time is CUDA-event time around ``reps``
    back-to-back calls, and a line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    warnings.filterwarnings('ignore', message='.*Profiler clears events.*')
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    phase(f'the profiler recorded no device time in {attempts} traces: CUDA-event time '
          'around back-to-back calls instead')
    return start.elapsed_time(end) / reps


def roi_inputs(rng, batch: int, k: int, canvas: int = 160, c: int = 256, device='cuda'):
    '''P2..P5 of a square canvas (40, 20, 10, 5 at 160; 64, 32, 16, 8 at 256)
    and boxes shaped like the main path's, drawn for a 160 canvas and scaled
    to ``canvas``: small mouse-sized boxes (level 2), with a quarter of the
    box stage's proposals large enough for level 3 (levels 3 and 4 at 256).'''
    import numpy as np
    import torch
    levels = [torch.from_numpy(rng.normal(0, 1, (batch, canvas // s, canvas // s, c))
                               .astype('float32')).to(device, torch.bfloat16)
              for s in (4, 8, 16, 32)]
    cx = rng.uniform(40, 120, (batch, k))
    cy = rng.uniform(40, 120, (batch, k))
    w = rng.uniform(12, 60, (batch, k))
    h = rng.uniform(8, 40, (batch, k))
    if k > 1:
        w[:, : k // 4] = rng.uniform(115, 160, (batch, k // 4))
        h[:, : k // 4] = rng.uniform(115, 160, (batch, k // 4))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1) * (canvas / 160)
    boxes = np.clip(boxes, 0, canvas).astype('float32')
    return levels, torch.from_numpy(boxes).to(device)


def roi_bound(levels, boxes, out: int, out_bytes: int = 2):
    '''(bytes, ops) the function needs on these inputs: the distinct taps it
    reads (per image), the boxes, the output (``out_bytes`` an element);
    ROI_OPS_PER_OUTPUT (32) fp32 operations per output element.'''
    import torch
    from moseq2_detectron_extract_tpu_torch.ops.roi_align import (_roi_sample_coords,
                                                                  assign_fpn_levels)
    b, k = boxes.shape[:2]
    c = levels[0].shape[-1]
    flat = boxes.reshape(-1, 4)
    lvl = (assign_fpn_levels(flat) - 2).long()
    strides = (2.0 ** (lvl + 2)).float()
    ys, xs = _roi_sample_coords(flat, out, strides)
    taps = 0
    for li, feat in enumerate(levels):
        hh, ww = feat.shape[1], feat.shape[2]
        sel = lvl == li
        if not sel.any():
            continue

        def touched(coords, size):
            cs = coords.clamp(0, size - 1)
            c0 = cs.floor().long()
            hit = torch.zeros((coords.shape[0], size), dtype=torch.bool, device=coords.device)
            hit.scatter_(1, c0, True)
            hit.scatter_(1, (c0 + 1).clamp(max=size - 1), True)
            return hit

        rows = touched(ys[sel], hh)                    # (n, H)
        cols = touched(xs[sel], ww)                    # (n, W)
        img = torch.div(torch.nonzero(sel)[:, 0], k, rounding_mode='floor')
        grid = torch.zeros((b, hh, ww), dtype=torch.int32, device=boxes.device)
        for part in range(0, rows.shape[0], 4096):     # (n, H, W) in slices of 4096 ROIs
            sl = slice(part, part + 4096)
            grid.index_add_(0, img[sl], (rows[sl, :, None] & cols[sl, None, :]).int())
        taps += int((grid > 0).sum())
    out_elems = b * k * out * out * c
    nbytes = taps * c * 2 + boxes.numel() * 4 + out_elems * out_bytes
    return nbytes, out_elems * ROI_OPS_PER_OUTPUT


def bf16_ulps(a, b):
    '''Distance in bf16 steps between two bf16 tensors (ordered codes).'''
    import torch

    def code(x):
        bits = x.to(torch.bfloat16).contiguous().view(torch.int16).long()
        return torch.where(bits < 0, -(bits & 0x7fff), bits)
    return (code(a) - code(b)).abs()


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


MAIN_STAGES = (('box', 7, 16), ('mask', 14, 1), ('keypoint', 7, 1))   # (stage, out, K)


def check_roi_stages(rng, reps: int, card: str, stages=MAIN_STAGES, canvas: int = 160,
                     label: str = 'roi_align'):
    '''ROIAlign's stages at batch 16 on ``canvas``, each against the plain
    version (2 bf16 ulps of its magnitude, at most 0.2% of the elements off
    and 0.1% two ulps or more), with its launch plan, device ms (kernel,
    plain, through the registered op), bound and share of it. Returns the
    stages summed (one batch's pooling) and each stage's numbers.'''
    import torch
    from moseq2_detectron_extract_tpu_torch.ops import roi_align_kernel
    from moseq2_detectron_extract_tpu_torch.ops.roi_align import separable_batched_roi_align

    roi = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'max_abs_err': 0.0,
           'bytes': 0, 'ops': 0, 'stages': {}}
    for stage, out, k in stages:
        levels, boxes = roi_inputs(rng, 16, k, canvas)
        got = roi_align_kernel.roi_align_cuda(levels, boxes, out)
        ref = separable_batched_roi_align(levels, boxes, out, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        allowed = BF16_TOL * (1 + ref.float().abs())
        if not bool((err <= allowed).all()):
            raise AssertionError(f'{label} {stage}: kernel differs from plain version '
                                 f'(max abs err {float(err.max()):.3e})')
        ulps = bf16_ulps(got, ref)
        far = ulps >= 2
        phase(f'{label} {stage}: kernel against the plain version in bf16 ulps: max '
              f'{int(ulps.max())}, {int((ulps == 1).sum())} elements one ulp off, '
              f'{int(far.sum())} two or more (their max abs err '
              f'{float(err[far].max()) if far.any() else 0.0:.3e}), of {ulps.numel()}')
        if int((ulps >= 1).sum()) > 2e-3 * ulps.numel() or int(far.sum()) > 1e-3 * ulps.numel():
            raise AssertionError(f'{label} {stage}: more elements off the plain version than '
                                 'the shared bf16 rounding allows (0.2%, 0.1% two ulps)')
        roi['one_ulp'] = roi.get('one_ulp', 0) + int((ulps == 1).sum())
        roi['max_ulps'] = max(roi.get('max_ulps', 0), int(ulps.max()))
        kernel = functools.partial(roi_align_kernel.roi_align_cuda, levels, boxes, out)
        plain = functools.partial(separable_batched_roi_align, levels, boxes, out,
                                  out_dtype=torch.bfloat16)
        via_op = functools.partial(torch.ops.m2de.roi_align_bf16, levels, boxes, out, 2)
        if not torch.equal(via_op(), got):
            raise AssertionError(f'{label} {stage}: the registered op differs from the launch')
        ms, plain_ms = device_ms(kernel, reps), device_ms(plain, reps)
        wall, plain_wall = wall_ms(kernel, reps), wall_ms(plain, reps)
        op_ms, op_wall = device_ms(via_op, reps), wall_ms(via_op, reps)
        nbytes, ops = roi_bound(levels, boxes, out)
        b_ms, by = bound_ms(nbytes, ops)
        plan = roi_align_kernel.launch_plan(16 * k, 256, out, 8)
        phase(f'{label} {stage} plan: {plan.warps} warps, one per (ROI, output row, '
              f'segment of {-(-out // plan.segs)} columns), {plan.vec} channels a lane')
        phase(f'{label} {stage} (B=16, K={k}, out={out}, C=256, canvas {canvas}): '
              f'max_abs_err {float(err.max()):.3e} (tol {BF16_TOL:.4f}*(1+|ref|)); device ms: '
              f'kernel {ms:.4f}, plain {plain_ms:.4f}, bound {b_ms:.4f} by {by} ({nbytes} B, '
              f'{ops} ops; the kernel at {100 * b_ms / ms:.1f}% of it); wall ms per call: '
              f'kernel {wall:.4f}, plain {plain_wall:.4f}; through the registered op '
              f'm2de::roi_align_bf16 (bit for bit the launch): device ms {op_ms:.4f}, wall ms '
              f'{op_wall:.4f} [{card}]')
        roi['ms'] += ms
        roi['op_ms'] = roi.get('op_ms', 0.0) + op_ms
        roi['plain_ms'] += plain_ms
        roi['max_abs_err'] = max(roi['max_abs_err'], float(err.max()))
        roi['bytes'] += nbytes
        roi['ops'] += ops
        roi['stages'][stage] = {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
                                'bound_by': by, 'max_abs_err': float(err.max())}
    roi['bound_ms'], roi['bound_by'] = bound_ms(roi['bytes'], roi['ops'])
    return roi


def check_kernels(rng, reps: int, card: str):
    '''Phase 3: each kernel against its plain version at main-path shapes.'''
    import torch
    from moseq2_detectron_extract_tpu_torch.ops import clean_kernel

    roi = check_roi_stages(rng, reps, card)

    frames = torch.from_numpy(rng.integers(0, 256, (64, 160, 160)).astype('uint8')).cuda()
    got = clean_kernel.clean_frames_cuda(frames)
    ref = clean_kernel.clean_frames_plain(frames)
    torch.cuda.synchronize()
    mismatched = int((got != ref).sum())
    if mismatched:
        raise AssertionError(f'clean: kernel differs from plain version at {mismatched} pixels')
    kernel = functools.partial(clean_kernel.clean_frames_cuda, frames)
    plain = functools.partial(clean_kernel.clean_frames_plain, frames)
    ms, plain_ms = device_ms(kernel, reps), device_ms(plain, reps)
    wall, plain_wall = wall_ms(kernel, reps), wall_ms(plain, reps)
    nbytes = 2 * frames.numel()
    ops = CLEAN_OPS_PER_PIXEL * frames.numel()
    b_ms, by = bound_ms(nbytes, ops, MINMAX_PER_S)
    plan = clean_kernel.tile_plan(*frames.shape)
    phase(f'clean plan: {plan.tile_h} x {plan.tile_w} tiles, {plan.blocks} blocks of two '
          f'frames, {plan.smem_bytes} B shared memory')
    phase(f'clean (64, 160, 160) uint8: bit-exact; device ms: kernel {ms:.4f}, plain '
          f'{plain_ms:.4f}, bound {b_ms:.4f} by {by} ({nbytes} B, {ops} ops); wall ms per '
          f'call: kernel {wall:.4f}, plain {plain_wall:.4f} [{card}]')
    clean = {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': by,
             'max_abs_err': float((got.int() - ref.int()).abs().max())}
    return roi, clean


NMS_IOU_OPS = 12                   # max 2, min 2, sub 2, clamp 2, mul, add, sub, div
NMS_BOX_BYTES = 16 + 4 + 1 + 1     # box, score, valid in; keep out
# (label, B, candidates per level, level-shifted): the faithful model's
# proposal NMS at inference and in training, and its box head's NMS
NMS_SHAPES = (('proposal', 50, (1000, 1000, 768, 192, 48), True),
              ('train', 8, (2000, 2000, 768, 192, 48), True),
              ('box', 50, (1000,), False))


def event_ms(fn, reps: int) -> float:
    '''CUDA-event time of ``reps`` back-to-back calls, per call, after one
    call to warm up.'''
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_nms(reps: int, card: str, seed: int) -> dict:
    '''Phase 3c: the NMS kernel against the plain fixpoint at the main
    path's shapes, and their times beside the bound.'''
    import ctypes
    import torch
    from moseq2_detectron_extract_tpu_torch import native
    from moseq2_detectron_extract_tpu_torch.ops import nms
    from moseq2_detectron_extract_tpu_torch.synthetic import proposal_pool
    lib = native.load_library()
    plain_op = lambda b, s, v, t: nms.nms_keep_mask_plain(b, s, t, v)
    kernel_op = nms.keep_mask_op
    rows = {}
    for label, b, level_k, shifted in NMS_SHAPES:
        boxes, scores, levels, valid = (t.cuda() for t in proposal_pool(
            b, level_k, seed=seed + sum(level_k)))
        k = boxes.shape[1]
        if shifted:
            call = functools.partial(nms.batched_nms_keep_mask, boxes, scores, levels, 0.7,
                                     valid=valid)
        else:
            call = functools.partial(nms.nms_keep_mask, boxes, scores, 0.7, valid=valid)
        torch.cuda.synchronize()
        nms.sync_count, nms.launch_count = 0, 0
        torch.cuda.set_sync_debug_mode('error')
        try:
            keep = call()
        finally:
            torch.cuda.set_sync_debug_mode('default')
        launches, syncs = nms.launch_count, nms.sync_count
        nms.keep_mask_op = plain_op
        try:
            plain = call()
            plain_rounds = nms.sync_count - 1
            plain_ms = event_ms(call, max(2, reps // 4))
        finally:
            nms.keep_mask_op = kernel_op
        torch.cuda.synchronize()
        if (launches, syncs) != (1, 0) or not torch.equal(keep, plain):
            raise AssertionError(f'nms {label} (B {b}, K {k}): {launches} launches, {syncs} '
                                 f'syncs, {int((keep != plain).sum())} keep bits differ')
        ms = event_ms(call, reps)
        ops = NMS_IOU_OPS * b * k * (k - 1) // 2
        nbytes = NMS_BOX_BYTES * b * k
        b_ms, by = bound_ms(nbytes, ops)
        plan = nms.launch_plan(k)
        held = ctypes.c_int(0)
        native.check(lib.m2de_nms_max_active_clusters(k, plan.cluster, plan.words_per_cta,
                                                       int(plan.bits_in_smem),
                                                       ctypes.byref(held)), 'occupancy')
        phase(f'nms {label} (B {b}, K {k}{", level-shifted" if shifted else ""}): keep mask '
              f'equal to the plain fixpoint ({int(keep.sum())} of {int(valid.sum())} valid '
              f'kept; {plain_rounds} plain rounds), 1 launch, 0 host syncs; plan: clusters of '
              f'{plan.cluster} CTAs x {plan.words_per_cta} words, bits in '
              f'{"shared" if plan.bits_in_smem else "device"} memory, {plan.smem_bytes} B '
              f'shared, {held.value} clusters at once; ms: kernel {ms:.4f}, plain '
              f'{plain_ms:.4f}, bound {b_ms:.4f} by {by} ({ops:.3e} ops, {nbytes} B), share '
              f'{100 * b_ms / ms:.1f}% [{card}]')
        rows[label] = {'b': b, 'k': k, 'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
                       'bound_by': by, 'clusters_at_once': held.value}
    return rows


def dense_tc_ms(levels, boxes, out: int, block_k: int) -> float:
    '''The dense separable form's multiply-adds (stage 1 over every stacked
    row, stage 2 over every column, the ROIs padded to block_k) x 2 over the
    card's bf16 tensor-core rate, in ms.'''
    b, k = boxes.shape[:2]
    kp = -(-k // block_k) * block_k
    h = sum(f.shape[1] for f in levels)
    w = max(f.shape[2] for f in levels)
    c = levels[0].shape[-1]
    macs = b * kp * out * w * c * (h + out)
    return 2 * macs / TC_BF16_OPS_PER_S * 1e3


def check_stage2(rng, reps: int, card: str, seed: int):
    '''Phase 3b: the stage-2 experiment's path, then each stage-2 kernel
    against its plain version; the launches of the path and the report rows.'''
    import torch
    from moseq2_detectron_extract_tpu_torch import native
    from moseq2_detectron_extract_tpu_torch.benchmarks import roi_stage2_exp as exp
    from moseq2_detectron_extract_tpu_torch.ops import roi_align_kernel
    from moseq2_detectron_extract_tpu_torch.ops import roi_stage2_kernel as rs
    from moseq2_detectron_extract_tpu_torch.ops.roi_align import _separable_inputs

    for variant in rs.VARIANTS:
        rs.launch_count[variant] = 0
    result = exp.main(device='cuda', seed=seed, reps=STAGE2_REPS)
    launches = dict(rs.launch_count)
    phase(f'stage-2 experiment launches: {launches}')
    if not all(launches.values()):
        raise AssertionError(f'a stage-2 kernel was not launched by the experiment: {launches}')
    exp_ms = {(r['label'], r['block_k']): r['ms'] for r in result['rows']}

    lib = native.load_library()
    bk = STAGE2_BLOCK_K
    levels64, boxes64 = result['inputs']
    shapes = {'box': roi_inputs(rng, 16, 16),
              'experiment B=4': ([f[:4] for f in levels64], boxes64[:4].contiguous())}
    box_levels, box_boxes = shapes['box']
    dense = _separable_inputs(box_levels, box_boxes, 7, 2, as_dtype=torch.bfloat16)
    yard = {'roi_align_cuda': device_ms(functools.partial(
                roi_align_kernel.roi_align_cuda, box_levels, box_boxes, 7), reps),
            'two calls': device_ms(functools.partial(exp.two_calls, *dense), reps),
            'dense tensor-core': dense_tc_ms(box_levels, box_boxes, 7, bk)}
    del dense
    yard64 = {'roi_align_cuda': exp_ms[('base (roi_align_cuda)', None)],
              'two calls': exp_ms[('two calls (bmm + matmul)', None)],
              'dense tensor-core': dense_tc_ms(levels64, boxes64, 7, bk)}
    phase('stage-2 yardsticks, box (B=16, K=16, canvas 160, C=256; device ms): '
          + ', '.join(f'{k} {v:.4f}' for k, v in yard.items())
          + f'; experiment (B=64, K=256, canvas 256, C=256; CUDA events, {STAGE2_REPS} '
          'calls): ' + ', '.join(f'{k} {v:.4f}' for k, v in yard64.items()) + f' [{card}]')

    exp_inputs = {k: rs.stage2_inputs(levels64, boxes64, 7, k)[1:] for k in exp.BLOCK_KS}
    box_inputs = rs.stage2_inputs(box_levels, box_boxes, 7, bk)[1:]
    rows = {}
    for label, variant, dtype in exp.RUNS:
        errs = {}
        for name, (levels, boxes) in shapes.items():
            inputs = rs.stage2_inputs(levels, boxes, 7, bk)
            got = rs.roi_stage2_cuda(*inputs, boxes.shape[1], variant, bk, dtype).float()
            ref = rs.roi_stage2_plain(levels, boxes, 7, variant, bk, dtype).float()
            torch.cuda.synchronize()
            err = (got - ref).abs()
            if not bool((err <= BF16_TOL * (1 + ref.abs())).all()):
                raise AssertionError(f'roi_stage2 {label} ({name}): kernel differs from plain '
                                     f'version (max abs err {float(err.max()):.3e})')
            errs[name] = float(err.max())
            del got, ref, err
        inputs = rs.stage2_inputs(box_levels, box_boxes, 7, bk)
        ms = device_ms(functools.partial(rs.roi_stage2_cuda, *inputs, 16, variant, bk,
                                         dtype), reps)
        plain_ms = device_ms(functools.partial(rs.roi_stage2_plain, box_levels, box_boxes, 7,
                                               variant, bk, dtype), reps)
        out_bytes = torch.empty((), dtype=dtype).element_size()
        b_ms, by = bound_ms(*roi_bound(box_levels, box_boxes, 7, out_bytes))
        b64_ms, by64 = bound_ms(*roi_bound(levels64, boxes64, 7, out_bytes))
        plan = rs.launch_plan(variant, 16, 16, 256, 75, 40, bk)
        plan64 = rs.launch_plan(variant, 64, 256, 256, 120, 64, bk)
        for name, p in (('box', plan), ('experiment', plan64)):
            # the channel slice as the C launcher chooses it, held against the plan
            launched_cs = lib.m2de_roi_stage2_resident_cs(p.hp, p.wp)
            if launched_cs != p.cs:
                raise AssertionError(f'roi_stage2 {label} ({name}): the launcher takes '
                                     f'{launched_cs} channels a block, the plan {p.cs}')
            phase(f'roi_stage2 {label} plan ({name}, block_k {bk}): {p.blocks} blocks of '
                  f'{rs.THREADS} threads, {p.cs} channels and {p.pairs} ROI pairs a block, '
                  f'{p.smem_bytes} B shared memory')
        phase(f'roi_stage2 {label}: max_abs_err box {errs["box"]:.3e}, experiment B=4 '
              f'{errs["experiment B=4"]:.3e} (tol {BF16_TOL:.4f}*(1+|ref|)); box device ms: '
              f'kernel {ms:.4f}, plain {plain_ms:.4f}, bound {b_ms:.4f} by {by}; experiment '
              f'B=64 ms: block_k 8 {exp_ms[(label, 8)]:.4f}, block_k 16 '
              f'{exp_ms[(label, 16)]:.4f}, bound {b64_ms:.4f} by {by64} [{card}]')
        rates = []
        for name, (wy, wx), k, t in [('box', box_inputs, bk, ms)] + [
                (f'experiment block_k {k}', exp_inputs[k], k, exp_ms[(label, k)])
                for k in exp.BLOCK_KS]:
            s1, s2 = rs.mma_count(variant, wy, wx, k, 256)
            rates.append(f'{name} {s1} + {s2}, {(s1 + s2) * 2048 * 2 / t / 1e9:.1f} TFLOP/s')
        phase(f'roi_stage2 {label}: mma.m16n8k16 issued (stage 1 + stage 2) and the rate: '
              + '; '.join(rates) + f' (dense bf16 peak 989) [{card}]')
        rows[label] = {'max_abs_err': max(errs.values()), 'ms': ms, 'plain_ms': plain_ms,
                       'bound_ms': b_ms, 'bound_by': by,
                       'experiment_ms': {str(k): exp_ms[(label, k)] for k in exp.BLOCK_KS},
                       'experiment_bound_ms': b64_ms}
    # Each kernel redesigned last beside its twin on the same loop, then both
    # again at the experiment's shape in alternating windows of STAGE2_REPS
    # calls, so that a drift over the run shows as a spread and not as a
    # difference between the two.
    runs = {label: (variant, dtype) for label, variant, dtype in exp.RUNS}
    exp_full = rs.stage2_inputs(levels64, boxes64, 7, bk)
    k64 = boxes64.shape[1]
    for new, twin in (('transpose', 'retile'), ('dotswap', 'noxpose')):
        a, c = rows[new], rows[twin]
        windows = {new: [], twin: []}
        for _ in range(STAGE2_WINDOWS):
            for label in windows:
                variant, dtype = runs[label]
                windows[label].append(exp.event_ms(functools.partial(
                    rs.roi_stage2_cuda, *exp_full, k64, variant, bk, dtype), STAGE2_REPS))
        spread = '; '.join(
            f'{label} median {statistics.median(ms):.4f}, range {min(ms):.4f}-{max(ms):.4f}'
            for label, ms in windows.items())
        phase(f'roi_stage2 {new} vs {twin}, ms: box '
              f'{a["ms"]:.4f} vs {c["ms"]:.4f}; experiment block_k 8 '
              f'{a["experiment_ms"]["8"]:.4f} vs {c["experiment_ms"]["8"]:.4f}, block_k 16 '
              f'{a["experiment_ms"]["16"]:.4f} vs {c["experiment_ms"]["16"]:.4f} (each kernel '
              f'does the same work at both block_k, which only pads K: its two readings '
              f'repeat one measurement); experiment block_k {bk}, {STAGE2_WINDOWS} alternating '
              f'windows of {STAGE2_REPS} calls: {spread} [{card}]')
    return launches, rows


def stage_times(chunk, predictor, config, tracker) -> dict:
    '''Wall seconds of each stage of ``process_chunk`` on one chunk (host
    clock, each stage ended by a synchronize).'''
    import torch
    from moseq2_detectron_extract_tpu_torch.pipeline.steps import (dispatch_window_features,
                                                                   run_inference,
                                                                   select_instances)
    times = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    data = run_inference(torch.from_numpy(chunk), predictor, config)
    torch.cuda.synchronize()
    times['prep_and_detect'] = time.perf_counter() - t
    t = time.perf_counter()
    data = select_instances(data, config, tracker)
    torch.cuda.synchronize()
    times['select_and_gather'] = time.perf_counter() - t
    t = time.perf_counter()
    dispatch_window_features(data, config)
    torch.cuda.synchronize()
    times['clean_and_moments'] = time.perf_counter() - t
    times['chunk'] = sum(times.values())
    return times


def profile_chunk(chunk, predictor, config, tracker, card: str,
                  label: str = 'profiled chunk') -> None:
    '''One chunk under ``torch.profiler``: the device's busy share of its
    wall time (profiler overhead included) and the top kernels. A trace that
    records no device time is taken again, at most twice.'''
    import torch
    from moseq2_detectron_extract_tpu_torch.extract import process_chunk
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            process_chunk(chunk, predictor, config, tracker=tracker)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.device_time_total > 0]
        busy_us = sum(e.device_time_total for e in kernels)
        if busy_us > 0:
            break
    else:
        raise RuntimeError('the profiler recorded no device time in 3 traces')
    phase(f'{label}: wall {wall * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms '
          f'({100 * busy_us / 1e3 / (wall * 1e3):.1f}%), {len(kernels)} kernel names, '
          f'{sum(e.count for e in kernels)} launches [{card}]')
    copies = [e for e in kernels if 'copy' in e.key.lower()]
    phase(f'{label}: copy kernels {sum(e.device_time_total for e in copies) / 1e3:.3f} '
          f'ms in {sum(e.count for e in copies)} launches [{card}]')
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:TOP_KERNELS]:
        print(f'  {e.device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}', flush=True)


def check_chunk(out, launches: dict) -> int:
    '''``process_chunk``'s output on a chunk of FRAMES 424x512 frames at
    batch BATCH: the shapes, finite outputs and centroids, the windows, the
    launch counts (3 ROIAlign and 2 NMS per batch, 1 clean) and the mouse
    found in 90% of the frames, which it returns.'''
    import torch
    n = FRAMES
    inf = out['inference']
    batches = -(-n // BATCH)
    expect = {'boxes': (n, 1, 4), 'masks': (n, 1, 424, 512), 'keypoints': (n, 1, 8, 3)}
    for key, shape in expect.items():
        if tuple(inf[key].shape) != shape:
            raise AssertionError(f'{key} shape {tuple(inf[key].shape)} != {shape}')
    for key in ('boxes', 'scores', 'keypoints', 'mask_probs'):
        if not bool(torch.isfinite(inf[key]).all()):
            raise AssertionError(f'non-finite {key}')
    fd = out['feat_dispatch']
    if tuple(fd['cleaned_frames'].shape) != (n, 160, 160):
        raise AssertionError(f'cleaned windows shape {tuple(fd["cleaned_frames"].shape)}')
    found = int(out['num_instances'].sum())
    has = torch.from_numpy(out['num_instances'] > 0).cuda()
    if not bool(torch.isfinite(fd['feats_dev']['centroid'][has]).all()):
        raise AssertionError('non-finite centroid of a selected instance')
    if launches['roi_align'] != 3 * batches or launches['clean'] != 1 \
            or launches['nms'] != 2 * batches:
        raise AssertionError(f'launch counts {launches}; expected roi_align '
                             f'{3 * batches} (3 per batch), clean 1, nms {2 * batches} '
                             '(the proposal and the box NMS)')
    if found < 0.9 * n:
        raise AssertionError(f'the mouse was found in only {found} of {n} frames')
    return found


def time_chunks(predictor, config, tracker, seed: int, card: str, label: str = '') -> None:
    '''CHUNKS timed chunks of FRAMES sentinel frames made from ``seed`` + 1
    on (``stage_times``: the median of each stage and of the chunk, peak
    device memory), then one more under ``torch.profiler``
    (``profile_chunk``).'''
    import torch
    from moseq2_detectron_extract_tpu_torch.synthetic import make_sentinel_chunk
    n = FRAMES
    chunks = [make_sentinel_chunk(n, 424, 512, seed=seed + 1 + i) for i in range(CHUNKS + 1)]
    torch.cuda.reset_peak_memory_stats()
    runs = [stage_times(c, predictor, config, tracker) for c in chunks[:CHUNKS]]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    medians = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    phase(f'{label}{CHUNKS} timed chunks, median wall ms: ' + ', '.join(
        f'{k} {v * 1e3:.2f}' for k, v in medians.items()) + f' [{card}]')
    phase(f'{label}chunk: {n} frames at {n / medians["chunk"]:.1f} frames/s (median; chunks '
          + ', '.join(f'{n / r["chunk"]:.1f}' for r in runs)
          + f'), peak memory {peak_gib:.2f} GiB [{card}]')
    profile_chunk(chunks[CHUNKS], predictor, config, tracker, card,
                  f'{label}profiled chunk')


def reference_check(model_dir: str, chunk, config, devices=('cuda', 'cpu')):
    '''The same 4 frames through the port on the card (kernels) and on the
    CPU (plain versions), both with the model in f32: ``valid`` and
    ``keep`` equal, boxes within 1 px, scores within 1e-2, the cleaned
    windows equal where the window origins agree. Returns the boxes', the
    scores' and the valid keypoints' (x, y) largest differences and the
    number of shared origins.'''
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch.extract import process_chunk
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.models.weights import (load_params_npz,
                                                                   params_from_jax)
    cfg = ModelConfig.from_yaml(os.path.join(model_dir, 'config.yaml')) \
        .replace(amp_dtype='float32')
    flat = load_params_npz(os.path.join(model_dir, 'params_f16.npz'))
    outs = {}
    for device in devices:
        pred = Predictor(cfg, params_from_jax(flat, cfg.box_pooler_resolution),
                         batch_size=4, device=device)
        outs[device] = process_chunk(chunk, pred, config)
    gpu, cpu = (outs[d] for d in devices)
    for key in ('valid', 'keep'):
        if not torch.equal(gpu['inference'][key].cpu(), cpu['inference'][key]):
            raise AssertionError(f'reference check: {key} differs between card and CPU')
    box_err = float((gpu['inference']['boxes'].cpu() - cpu['inference']['boxes']).abs().max())
    score_err = float((gpu['inference']['scores'].cpu() - cpu['inference']['scores']).abs().max())
    if box_err > 1.0 or score_err > 1e-2:
        raise AssertionError(f'reference check: boxes {box_err:.3f} px, scores {score_err:.2e}')
    same = np.all(gpu['win_origins'] == cpu['win_origins'], axis=1)
    cleaned_equal = bool(torch.equal(gpu['feat_dispatch']['cleaned_frames'].cpu()[same],
                                     cpu['feat_dispatch']['cleaned_frames'][same]))
    if not same.any() or not cleaned_equal:
        raise AssertionError('reference check: cleaned windows differ between card and CPU')
    valid = cpu['inference']['valid']
    kp_gap = (gpu['inference']['keypoints'].cpu() - cpu['inference']['keypoints'])[..., :2]
    kp_err = float(kp_gap[valid].abs().max()) if bool(valid.any()) else 0.0
    return box_err, score_err, kp_err, int(same.sum())


def tool_versions() -> None:
    '''First lines of ``g++ --version`` (the host prep's compiler) and
    ``ffmpeg -version`` (compressed video, which the port does not read).'''
    import shutil
    for tool, flag in (('g++', '--version'), ('ffmpeg', '-version')):
        path = shutil.which(tool)
        if path is None:
            print(f'{tool}: not found on PATH', flush=True)
            continue
        out = subprocess.run([path, flag], capture_output=True, text=True, timeout=60,
                             check=False)
        print(f'{tool}: {path}: {(out.stdout or out.stderr).splitlines()[0]}', flush=True)


def plane_errors(plane, ref):
    '''Max abs differences of two [a, b, c, d] planes: unit normal, d.'''
    import numpy as np
    diff = np.abs(np.asarray(plane, np.float64) - np.asarray(ref, np.float64))
    return float(diff[:3].max()), float(diff[3])


def written_rows(out: dict, first_frame_idx: int, into: dict) -> None:
    '''What the results writer writes of one chunk of ``extract_chunks``:
    the per-frame values of its true frames past its offset, at their rows
    (frame less ``first_frame_idx``), gathered into ``into``.'''
    import numpy as np
    n, off = out['nframes'], out['offset']
    rows = np.asarray(out['frame_idxs'][off:]) - first_frame_idx
    values = {f'scalars/{k}': v for k, v in out['scalars'].items()}
    values.update({f'keypoints/{k}': v for k, v in out['keypoints'].items()})
    values.update({'frames': out['depth_frames'], 'frames_mask': out['mask_frames'] > 0,
                   'metadata/extraction/flips': np.asarray(out['features']['flips'])})
    for key, v in values.items():
        v = np.asarray(v)[off:n]
        into.setdefault(key, []).append((rows, v.astype('float32') if v.dtype.kind == 'f'
                                         else v))


def drive_session(session, predictor, prepared: dict, card: str, label: str,
                  keep_chunk0: bool = False, keep_results: bool = False) -> dict:
    """The session's chunks through ``extract.extract_chunks`` (selection,
    brain and output ops, to ``fetch_results``), each stage timed on the
    host clock and ended by a synchronize: read+prep (the producer),
    ``process_chunk``, ``process_features`` (the brain's host seconds from
    its timers; the rest is the output ops' dispatch and device time) and
    ``fetch_results``. Prints a line per chunk and one for the session, with
    the kernels' launch counts set to 0 just before; checks each chunk's
    fetched results. Returns the rows, launches, the last chunk's true
    frames' smoothed centroid and orientation, and (``keep_chunk0``) chunk
    0's inputs to the output ops."""
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch import extract
    from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, roi_align_kernel
    from moseq2_detectron_extract_tpu_torch.utils.profiling import StageTimer

    stages = {'produce': extract.produce_chunks, 'process_chunk': extract.process_chunk,
              'process_features': extract.process_features,
              'fetch_results': extract.fetch_results}
    rows = []

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == 'process_features':
                kwargs['timers'] = rows[-1]['brain']
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rows[-1][name] = time.perf_counter() - t
            return out
        return run

    def timed_produce(*args):
        chunks = stages['produce'](*args)
        while True:
            rows.append({'brain': StageTimer()})
            t = time.perf_counter()
            item = next(chunks, None)
            rows[-1]['produce'] = time.perf_counter() - t
            if item is None:
                rows.pop()
                return
            yield item

    roi_align_kernel.launch_count = 0
    clean_kernel.launch_count = 0
    torch.cuda.reset_peak_memory_stats()
    extract.produce_chunks = timed_produce
    for name in ('process_chunk', 'process_features', 'fetch_results'):
        setattr(extract, name, timed(name, stages[name]))
    found, frames, chunk0, last = 0, 0, None, None
    results = {}
    chunk_size = prepared['chunk_size']
    crop = tuple(prepared['crop_size'])
    try:
        t0 = time.perf_counter()
        for out in extract.extract_chunks(session, predictor, prepared,
                                          tracker=extract.make_tracker()):
            n = out['nframes']
            rows[-1]['frames'] = n
            frames += n
            m = out['chunk'].shape[0]
            inf = out['inference']
            shape = (m, 1) + tuple(out['chunk'].shape[1:])
            if tuple(inf['masks'].shape) != shape:
                raise AssertionError(f'masks {tuple(inf["masks"].shape)} != {shape}')
            for key in ('boxes', 'scores', 'keypoints'):
                if not bool(torch.isfinite(inf[key]).all()):
                    raise AssertionError(f'session chunk: non-finite {key}')
            window = min(prepared['feature_window'], *out['chunk'].shape[1:])
            if tuple(out['feat_dispatch']['cleaned_frames'].shape) != (m, window, window):
                raise AssertionError('cleaned windows '
                                     f'{tuple(out["feat_dispatch"]["cleaned_frames"].shape)}')
            has = out['num_instances'][:n] > 0
            found += int(has.sum())
            feats = out['features']['features']
            expect = {'depth_frames': ((m, crop[1], crop[0]), np.uint8),
                      'mask_frames': ((m, crop[1], crop[0]), np.uint8),
                      'arena_mask_crops': ((m, window, window), np.uint8)}
            for key, (shape, dtype) in expect.items():
                if out[key].shape != shape or out[key].dtype != dtype:
                    raise AssertionError(f'{key} {out[key].shape} {out[key].dtype}')
            if len(out['scalars']) != 17 or len(out['keypoints']) != 8 * 12:
                raise AssertionError('scalars or keypoint dict incomplete')
            if not (np.isfinite(feats['centroid'][:n][has]).all()
                    and np.isfinite(feats['orientation'][:n][has]).all()
                    and np.isfinite(out['scalars']['height_ave_mm'][:n]).all()):
                raise AssertionError('non-finite smoothed features of a found mouse')
            last = (feats['centroid'][:n].copy(), feats['orientation'][:n].copy())
            if keep_results:
                written_rows(out, prepared['first_frame_idx'], results)
            if keep_chunk0 and chunk0 is None:
                fd = out['feat_dispatch']
                chunk0 = {'chunk_dev': out['chunk_dev'], 'raw_windows': out['raw_windows'],
                          'feat_masks': fd['feat_masks'], 'cleaned': fd['cleaned_frames'],
                          'origins': out['win_origins'], 'features': feats,
                          'keypoints': out['features']['keypoints'],
                          'frame_idxs': out['frame_idxs'], 'chunk': out['chunk'],
                          'config': prepared}
            del out, inf
        busy_s = time.perf_counter() - t0
    finally:
        for name, fn in stages.items():
            setattr(extract, 'produce_chunks' if name == 'produce' else name, fn)
    launches = {'roi_align': roi_align_kernel.launch_count, 'clean': clean_kernel.launch_count}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    upto = sum(r['produce'] + r['process_chunk'] for r in rows)
    for i, r in enumerate(rows):
        b = r['brain'].totals
        phase(f'{label} chunk {i}: {r["frames"]} true frames of {chunk_size}; read+prep '
              f'{r["produce"] * 1e3:.1f} ms (host), process_chunk {r["process_chunk"] * 1e3:.1f},'
              f' process_features {r["process_features"] * 1e3:.1f} (brain: moments pull '
              f'{b.get("itf_moments", 0) * 1e3:.1f}, EM init {b.get("itf_em_init", 0) * 1e3:.1f},'
              f' smooth_update {b.get("itf_kalman_smooth", 0) * 1e3:.1f}, flip votes '
              f'{b.get("itf_flip_votes", 0) * 1e3:.1f}, angle filter '
              f'{b.get("itf_angle_filter", 0) * 1e3:.1f}; output ops '
              f'{(r["process_features"] - sum(b.values())) * 1e3:.1f} ms with the device), '
              f'fetch_results {r["fetch_results"] * 1e3:.1f} ms (each ended by a synchronize) '
              f'[{card}]')
    phase(f'{label}: {frames} frames from disk in {busy_s:.3f} s = {frames / busy_s:.1f} '
          f'frames/s through fetch_results ({frames / upto:.1f} up to process_chunk); '
          f'detections found in {found} of {frames} frames; launches {launches}; peak memory '
          f'{peak_gib:.2f} GiB [{card}]')
    return {'rows': rows, 'launches': launches, 'found': found, 'frames': frames,
            'busy_s': busy_s, 'last': last, 'chunk0': chunk0, 'results': results}


def _half_edge(values, tol: float = 1e-3):
    """Where f32 values sit within ``tol`` of a .5 edge of rounding."""
    import torch
    return (values - torch.floor(values) - 0.5).abs() <= tol


def check_output_ops(chunk0: dict, card: str) -> None:
    """The output ops on the card against the CPU, on chunk 0's inputs:
    crop-and-rotate of the depth (f32 to 1e-3; uint8 equal but at .5 edges)
    and of the feature masks (thresholded and packed: equal but at 0.5
    edges), the z lookup, the height stats, the 17 scalars and the keypoint
    dict on the same host inputs; then each op's device ms (CUDA events,
    median of single calls)."""
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch.ops.instances import packbits_device
    from moseq2_detectron_extract_tpu_torch.ops.warp import crop_and_rotate_frames
    from moseq2_detectron_extract_tpu_torch.proc.keypoints import (dispatch_z_lookup,
                                                                   keypoints_to_dict)
    from moseq2_detectron_extract_tpu_torch.proc.scalars import (compute_scalars,
                                                                 dispatch_scalar_stats)
    config = chunk0['config']
    crop = tuple(config['crop_size'])
    feats = chunk0['features']
    centroid, angles = feats['centroid'], feats['orientation']
    local = centroid - np.asarray(chunk0['origins'])[:, ::-1]
    masks_u8 = chunk0['feat_masks'].to(torch.uint8)
    masked = chunk0['raw_windows'] * chunk0['feat_masks']

    def ops(dev):
        depth = crop_and_rotate_frames(chunk0['chunk_dev'].to(dev), centroid, angles, crop)
        masks = crop_and_rotate_frames(masks_u8.to(dev), local, angles, crop)
        return {'depth': depth, 'masks': masks, 'packed': packbits_device(masks > 0.5),
                'z': dispatch_z_lookup(chunk0['keypoints'], chunk0['cleaned'].to(dev),
                                       chunk0['origins']),
                'stats': dispatch_scalar_stats(masked.to(dev), config['min_height'],
                                               config['max_height'])}

    gpu, cpu = ops('cuda'), ops('cpu')
    crop_err = float((gpu['depth'].cpu() - cpu['depth']).abs().max())
    u8 = [torch.clamp(torch.round(x), 0, 255).to(torch.uint8) for x in (gpu['depth'].cpu(),
                                                                         cpu['depth'])]
    u8_diff = u8[0] != u8[1]
    depth_edges_only = bool((~u8_diff | _half_edge(cpu['depth'])).all())
    mask_diff = (gpu['masks'].cpu() > 0.5) != (cpu['masks'] > 0.5)
    at_half = (cpu['masks'] - 0.5).abs() <= 1e-3
    mask_edges_only = bool((~mask_diff | at_half).all())
    edge_bytes = torch.from_numpy(np.packbits(at_half.numpy(), axis=-1) > 0)
    packed_equal = bool((gpu['packed'].cpu() == cpu['packed'])[~edge_bytes].all())
    z_equal = bool(torch.equal(gpu['z'].cpu(), cpu['z']))
    area_equal = bool(torch.equal(gpu['stats'][0].cpu(), cpu['stats'][0]))
    h_gpu, h_cpu = gpu['stats'][1].cpu().double(), cpu['stats'][1].double()
    height_rel = float(((h_gpu - h_cpu).abs() / h_cpu.abs().clamp(min=1e-12)).max())
    true_depth = config['true_depth']
    sc = [compute_scalars(None, feats, config['min_height'], config['max_height'], true_depth,
                          height_stats=out['stats']) for out in (gpu, cpu)]
    kd = [keypoints_to_dict(chunk0['keypoints'], None, centroid, angles, true_depth,
                            frame_origins=chunk0['origins'], z_data=out['z']) for out in (gpu, cpu)]
    scalars_equal = all(np.array_equal(sc[0][k], sc[1][k], equal_nan=True) for k in sc[1])
    kpts_equal = all(np.array_equal(kd[0][k], kd[1][k], equal_nan=True) for k in kd[1])
    phase(f'output ops, card vs CPU on chunk 0 ({tuple(cpu["depth"].shape)} crops from '
          f'{tuple(chunk0["chunk_dev"].shape)}): crop max abs err {crop_err:.3e} (tol 1e-3); '
          f'uint8 crops differing {int(u8_diff.sum())} of {u8_diff.numel()} px, all at .5 '
          f'edges: {depth_edges_only}; masks differing {int(mask_diff.sum())} px, all at 0.5 '
          f'edges: {mask_edges_only}; packed masks equal off edges: {packed_equal}; z equal: '
          f'{z_equal}; area_px equal: {area_equal}; height_ave_mm max rel err '
          f'{height_rel:.2e} (tol 1e-5); 17 scalars equal: {scalars_equal}; keypoint dict '
          f'equal: {kpts_equal} [{card}]')
    if not (crop_err <= 1e-3 and depth_edges_only and mask_edges_only and packed_equal
            and z_equal and area_equal and height_rel <= 1e-5 and scalars_equal and kpts_equal):
        raise AssertionError('the output ops on the card differ from the CPU')
    chunk_dev, cleaned = chunk0['chunk_dev'], chunk0['cleaned']
    masks_dev = masks_u8.to('cuda')
    timings = {
        'crop depth': lambda: crop_and_rotate_frames(chunk_dev, centroid, angles, crop),
        'crop masks': lambda: crop_and_rotate_frames(masks_dev, local, angles, crop),
        'pack masks': lambda: packbits_device(gpu['masks'] > 0.5),
        'z lookup': lambda: dispatch_z_lookup(chunk0['keypoints'], cleaned, chunk0['origins']),
        'height stats': lambda: dispatch_scalar_stats(masked, config['min_height'],
                                                      config['max_height'])}
    phase('output ops on chunk 0, device ms (CUDA events around single calls, median of 5, '
          'host launch time included): ' + ', '.join(
              f'{name} {wall_ms(fn, 5):.3f}' for name, fn in timings.items()) + f' [{card}]')


def time_smoothers(card: str, seed: int) -> None:
    """The smoother backends on this machine's host at the point tracker's
    size (S 54, O 18), T 1000 with 5% of the rows missing: median ms of 5
    for numpy and the C++ core (and steady with none missing), held to each
    other to 1e-9; the backend the port picks; the angle filter's ms per
    1000 frames."""
    import numpy as np
    from moseq2_detectron_extract_tpu_torch.pipeline.steps import make_feature_trackers
    from moseq2_detectron_extract_tpu_torch.proc import kalman
    rng = np.random.default_rng(seed)
    n = 1000
    centroid = 200 + np.cumsum(rng.normal(0, 1.5, (n, 2)), axis=0)
    kpts = centroid[:, None, :] + rng.normal(0, 4, (n, 8, 2))
    angles = np.cumsum(rng.normal(0, 4, n)) % 360
    point, angle = make_feature_trackers({'use_tracking': True, 'num_keypoints': 8})
    t = time.perf_counter()
    point.initialize([centroid, kpts])
    em_s = time.perf_counter() - t
    angle.initialize([angles])
    obs, _ = point._obs_and_missing([centroid, kpts])
    missing = rng.random(n) < 0.05
    s_dim, o_dim = point.params.transition.shape[0], obs.shape[1]

    def median_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t)
        return 1e3 * statistics.median(times), out

    ms = {}
    ms['numpy'], numpy_out = median_ms(lambda: kalman.kalman_smooth(point.params, obs, missing,
                                                                     backend='numpy'))
    ms['native'], native_out = median_ms(lambda: kalman.kalman_smooth(point.params, obs,
                                                                       missing, backend='native'))
    ms['steady, none missing'], _ = median_ms(lambda: kalman.kalman_smooth(
        point.params, obs, np.zeros(n, bool)))
    err = max(float(np.abs(numpy_out[k] - native_out[k]).max())
              for k in ('means', 'covs', 'lag_one_covs'))
    scores = rng.uniform(0.2, 1.0, n)
    filter_ms, _ = median_ms(lambda: kalman.angle_intervention_filter(
        angle.params, angle.last_mean, angle.last_covar, angles, scores))
    faster = min(('numpy', 'native'), key=ms.get)
    phase(f'smoother backends on the host (S {s_dim}, O {o_dim}, T {n}, {int(missing.sum())} '
          f'rows missing; median ms of 5): ' + ', '.join(f'{k} {v:.1f}' for k, v in ms.items())
          + f'; native vs numpy max abs err {err:.2e} (tol 1e-9); faster with missing rows: '
          f'{faster}; the port picks {kalman.MISSING_ROWS_BACKEND}; EM init (10 iterations, '
          f'T {n}) {em_s * 1e3:.1f} ms; angle filter {filter_ms:.1f} ms per {n} frames; C++ '
          f'fallbacks so far {kalman.native_fallbacks} [{card}]')
    if err > 1e-9:
        raise AssertionError('the C++ Kalman core differs from numpy')


def check_absent_session(predictor, card: str, seed: int, tmp: str) -> None:
    """A short session whose first frames have no mouse (its background is
    frame 0, the bare arena) through the whole path: the point tracker then
    smooths chunks with missing rows and both trackers must end finite."""
    import numpy as np
    from moseq2_detectron_extract_tpu_torch import extract
    from moseq2_detectron_extract_tpu_torch.io.session import Session
    from moseq2_detectron_extract_tpu_torch.proc import kalman
    from moseq2_detectron_extract_tpu_torch.synthetic import write_raw_session
    absent = (0, ABSENT_FRAMES)
    path = write_raw_session(os.path.join(tmp, 'absent'), ABSENT_SESSION, 424, 512,
                             seed=seed + 1, absent=absent)
    config = {**extract.DEFAULT_CONFIG, 'chunk_size': ABSENT_CHUNK, 'min_height': 0.0,
              'max_height': 100.0, 'feature_window': 160}
    session = Session(path)
    prepared = extract.prepare_session(session, config, device='cuda')
    trackers = extract.make_feature_trackers(prepared)
    fallbacks = kalman.native_fallbacks
    t = time.perf_counter()
    missing, frames, empty_absent = 0, 0, 0
    for out in extract.extract_chunks(session, predictor, prepared, feature_trackers=trackers):
        n = out['nframes']
        idx = out['frame_idxs']
        none = out['num_instances'][:n] == 0
        missing += int(none.sum())
        empty_absent += int((none & (idx >= absent[0]) & (idx < absent[1])).sum())
        frames += n
    wall = time.perf_counter() - t
    finite = all(np.isfinite(tr.last_mean).all() and np.isfinite(tr.last_covar).all()
                 for tr in trackers)
    phase(f'absent-mouse session: {frames} frames of 424x512 (no mouse in frames {absent[0]}-'
          f'{absent[1] - 1}), chunks of {ABSENT_CHUNK}: {missing} frames without a detection '
          f'({empty_absent} of the {absent[1] - absent[0]} empty ones), {frames / wall:.1f} '
          f'frames/s through fetch_results; trackers finite: {finite}; C++ fallbacks '
          f'{kalman.native_fallbacks - fallbacks} [{card}]')
    if missing == 0 or not finite:
        raise AssertionError('the absent-mouse session ran without missing rows or ended '
                             'with a non-finite tracker state')


def check_session(predictor, card: str, seed: int, model_dir: str, tmp: str):
    '''Phase 4b: a raw session on disk (written into ``tmp``, which the
    caller deletes) through ``prepare_session`` and ``extract_chunks`` to
    ``fetch_results`` (padded, then unpadded); the output ops on the card
    against the CPU; the smoother backends; a session with the mouse away;
    the card's ROI against the CPU's and the C++ prep against the plain one.
    Then phase 4c on the same session and on a longer one. Returns the
    path's kernel launches, phase 4c's, the session's path and
    ``prepare_session`` result (for phase 4e), phase 4c (a)'s results
    file (for phase 4f) and its deterministic run (for phase 4h).'''
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch import extract
    from moseq2_detectron_extract_tpu_torch.io.session import Session
    from moseq2_detectron_extract_tpu_torch.ops.preprocess import (prep_raw_frames_host,
                                                                   prep_raw_frames_plain)
    from moseq2_detectron_extract_tpu_torch.proc.roi import get_roi
    from moseq2_detectron_extract_tpu_torch.synthetic import rough_arena, write_raw_session

    t = time.perf_counter()
    path = write_raw_session(tmp, SESSION_FRAMES, 424, 512, seed=seed)
    phase(f'wrote {SESSION_FRAMES} frames of 424x512 ({os.path.getsize(path) / 1e6:.0f} MB)'
          f' in {time.perf_counter() - t:.1f} s')
    config = {**extract.DEFAULT_CONFIG, 'chunk_size': SESSION_CHUNK, 'chunk_overlap': 0,
              'read_block_frames': 32, 'min_height': 0.0, 'max_height': 100.0,
              'feature_window': 160}
    session = Session(path, frame_trim=config['frame_trim'])
    torch.cuda.synchronize()
    t = time.perf_counter()
    prepared = extract.prepare_session(session, config, device='cuda')
    torch.cuda.synchronize()
    roi_s = time.perf_counter() - t
    roi = prepared['roi']
    phase(f'find_roi (prepare_session, cuda): {roi_s * 1e3:.1f} ms wall; background from '
          f'{len(range(0, session.nframes, 500))} frames, ROI {int(roi.sum())} px, true '
          f'depth {prepared["true_depth"]}, plane {np.round(session.plane, 5).tolist()} '
          f'[{card}]')

    run = drive_session(session, predictor, prepared, card, 'session', keep_chunk0=True,
                        keep_results=True)
    rows, launches, frames = run['rows'], run['launches'], run['frames']
    batches = sum(-(-SESSION_CHUNK // BATCH) for _ in rows)
    if launches != {'roi_align': 3 * batches, 'clean': len(rows)}:
        raise AssertionError(f'session launches {launches}; expected roi_align '
                             f'{3 * batches} (3 per batch), clean {len(rows)}')
    if len(rows) != 2 or frames != SESSION_FRAMES:
        raise AssertionError(f'{len(rows)} chunks of {frames} frames')
    if run['found'] < 0.9 * frames:
        raise AssertionError(f'the mouse was found in only {run["found"]} of {frames} frames')
    chunk0 = run.pop('chunk0')
    check_output_ops(chunk0, card)
    chunk0 = (chunk0['frame_idxs'], chunk0['chunk'])

    unpadded = drive_session(session, predictor, dict(prepared, pad_chunks=False), card,
                             'unpadded session')
    (c_pad, o_pad), (c_unp, o_unp) = run['last'], unpadded['last']
    gap = np.abs(o_pad - o_unp) % 360
    phase(f'padded tail: the last chunk\'s {len(o_pad)} true frames, unpadded against '
          f'padded: smoothed centroid max abs diff {np.nanmax(np.abs(c_pad - c_unp)):.4f} '
          f'px, orientation {np.nanmax(np.minimum(gap, 360 - gap)):.4f} deg; session '
          f'{unpadded["frames"] / unpadded["busy_s"]:.1f} frames/s unpadded, '
          f'{frames / run["busy_s"]:.1f} padded [{card}]')
    if unpadded['frames'] != frames or unpadded['rows'][-1]['frames'] != len(o_pad):
        raise AssertionError('the unpadded session gave other chunks')

    time_smoothers(card, seed)
    check_absent_session(predictor, card, seed, tmp)

    warm_session = Session(path, frame_trim=config['frame_trim'])
    profiler = cProfile.Profile()
    torch.cuda.synchronize()
    t = time.perf_counter()
    profiler.enable()
    extract.prepare_session(warm_session, config, device='cuda')
    torch.cuda.synchronize()
    profiler.disable()
    warm_s = time.perf_counter() - t
    top = pstats.Stats(profiler).sort_stats('tottime').stats
    worst = sorted(top.items(), key=lambda kv: -kv[1][2])[:FIND_ROI_TOP]
    phase(f'find_roi again (a new Session, cuda, under cProfile): {warm_s * 1e3:.1f} ms wall '
          f'(first {roi_s * 1e3:.1f}); host time by function (own s): ' + ', '.join(
              f'{fn[2]} ({os.path.basename(fn[0])}:{fn[1]}) {st[2]:.3f}'
              for fn, st in worst) + f' [{card}]')

    t = time.perf_counter()
    cpu_session = Session(path, frame_trim=config['frame_trim'])
    cpu = extract.prepare_session(cpu_session, config, device='cpu')
    cpu_s = time.perf_counter() - t
    plane_err = plane_errors(session.plane, cpu_session.plane)
    same = {'roi': bool(np.array_equal(cpu['roi'], roi)),
            'bground_im': bool(np.array_equal(cpu['bground_im'], prepared['bground_im'])),
            'true_depth': cpu['true_depth'] == prepared['true_depth']}
    phase(f'prepare_session on the CPU ({cpu_s:.2f} s): equal to the card\'s {same}, plane '
          f'max abs err (normal, d) {plane_err[0]:.2e}, {plane_err[1]:.2e} (tol {PLANE_TOL})')
    if not all(same.values()) or plane_err[0] > PLANE_TOL[0] or plane_err[1] > PLANE_TOL[1]:
        raise AssertionError('the card\'s ROI discovery differs from the CPU\'s')
    for rough_seed in ROUGH_SEEDS:
        image = rough_arena(424, 512, rough_seed)
        (gpu_rois, gpu_plane), (cpu_rois, cpu_plane) = (
            get_roi(image, device=dev) for dev in ('cuda', 'cpu'))
        same_rois = len(gpu_rois) == len(cpu_rois) and all(
            np.array_equal(a, b) for a, b in zip(gpu_rois, cpu_rois))
        plane_err = plane_errors(gpu_plane, cpu_plane)
        phase(f'get_roi on rough_arena(424, 512, seed {rough_seed}): {len(gpu_rois)} ROIs, '
              f'equal to the CPU\'s: {same_rois}; plane max abs err (normal, d) '
              f'{plane_err[0]:.2e}, {plane_err[1]:.2e}')
        if not same_rois or plane_err[0] > PLANE_TOL[0] or plane_err[1] > PLANE_TOL[1]:
            raise AssertionError('the card\'s get_roi differs from the CPU\'s on a rough floor')

    idxs, chunk = chunk0
    t = time.perf_counter()
    (_, raw), = list(session.index(np.asarray(idxs) - session.first_frame_idx,
                                   chunk_size=len(idxs)))
    read_s = time.perf_counter() - t
    kwargs = dict(bground_im=session.bground_im, roi=session.roi, vmin=config['min_height'],
                  vmax=config['max_height'], dtype='uint8')
    t = time.perf_counter()
    cxx = prep_raw_frames_host(raw, **kwargs)
    cxx_s = time.perf_counter() - t
    t = time.perf_counter()
    plain = prep_raw_frames_plain(raw, **kwargs)
    plain_s = time.perf_counter() - t
    equal = bool(np.array_equal(cxx, plain)) and bool(np.array_equal(cxx, chunk[:len(idxs)]))
    phase(f'chunk 0 on the host: one read of its {len(idxs)} raw frames {read_s * 1e3:.1f} '
          f'ms; prep ({raw.shape} {raw.dtype} -> {cxx.shape} uint8): C++ {cxx_s * 1e3:.1f} '
          f'ms, plain numpy {plain_s * 1e3:.1f} ms, bit for bit equal (and to the chunk the '
          f'path ran): {equal} [{card}]')
    if not equal:
        raise AssertionError('the C++ host prep differs from the plain version')

    phase('4c/5 extract through the CLI: (a) the session above, (b) a 4,000-frame session')
    results_h5 = os.path.join(tmp, 'results_4c.h5')
    extract_launches, dat_run = check_extract(path, run['results'], prepared, card, seed,
                                              model_dir, results_h5)
    return launches, extract_launches, path, prepared, results_h5, dat_run


def _compare_file(h5_path: str, results: dict) -> dict:
    '''Per dataset, the frames of the results file that differ from
    ``results`` (``written_rows``), NaN equal to NaN.'''
    import numpy as np
    from moseq2_detectron_extract_tpu_torch.io import hdf5
    differ = {}
    with hdf5.File(h5_path, 'r') as r:
        for key, parts in results.items():
            data = r[key][()]
            count = 0
            for rows, values in parts:
                got = data[rows]
                same = (got == values) | ((got != got) & (values != values)) \
                    if values.dtype.kind == 'f' else got == values
                count += int((~same.reshape(len(rows), -1).all(axis=1)).sum())
            if count:
                differ[key] = count
    return differ


def check_avi(avi_path: str, nframes: int, card: str, label: str) -> dict:
    '''The AVI's index must hold exactly ``nframes`` frames, each a JPEG with
    SOI, a SOF0 of the video's size and EOI; prints its size. Returns the
    index (``io/mjpeg.py:read_avi_index``).'''
    from moseq2_detectron_extract_tpu_torch.io.mjpeg import read_avi_index
    index = read_avi_index(avi_path)
    size = os.path.getsize(avi_path)
    sof = index['sof_sizes']
    bad = [i for i, hw in enumerate(sof) if hw != (index['height'], index['width'])]
    phase(f'{label}: {os.path.basename(avi_path)} {size / 1e6:.2f} MB, {len(index["frames"])} '
          f'frames in the index ({size / max(len(index["frames"]), 1) / 1e3:.1f} KB a frame), '
          f'{index["width"]}x{index["height"]} at {index["rate"]} fps, RIFFs {index["riffs"]}; '
          f'SOI/EOI {"all" if index["jpeg_ok"] else "NOT all"} well formed, SOF0 sizes off '
          f'{len(bad)} [{card}]')
    if len(index['frames']) != nframes or index['dmlh_frames'] != nframes \
            or not index['jpeg_ok'] or bad or len(sof) != nframes:
        raise AssertionError(f'{label}: {avi_path} holds {len(index["frames"])} frames of '
                             f'{nframes}; JPEGs well formed {index["jpeg_ok"]}, SOF0 off {bad[:5]}')
    return index


def _run_cli(path: str, model_dir: str, out_dir: str, card: str, label: str, nframes: int,
             extra=()):
    '''``cli.main(['extract', path, '--model', model_dir, '--output-dir',
    out_dir, *extra])`` with the launch counts set to 0 just before and read
    just after; fails unless the status says ``complete: true`` and the preview
    holds the session's ``nframes`` frames (``check_avi``). Returns the
    status, the launches, the wall seconds, the peak device memory and the
    overall frames/s line that extract_session logged.'''
    import torch
    from moseq2_detectron_extract_tpu_torch import cli
    from moseq2_detectron_extract_tpu_torch.io.util import read_yaml
    from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, roi_align_kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    roi_align_kernel.launch_count = 0
    clean_kernel.launch_count = 0
    t = time.perf_counter()
    rc = cli.main(['extract', path, '--model', model_dir, '--output-dir', out_dir, *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {'roi_align': roi_align_kernel.launch_count, 'clean': clean_kernel.launch_count}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    status = read_yaml(os.path.join(out_dir, 'results_00.yaml'))
    if rc != 0 or status.get('complete') is not True:
        with open(os.path.join(out_dir, 'results_00.log'), encoding='utf-8') as fh:
            print(fh.read()[-6000:], file=sys.stderr)
        raise AssertionError(f'{label}: extract returned {rc}, status complete '
                             f'{status.get("complete")!r}')
    with open(os.path.join(out_dir, 'results_00.log'), encoding='utf-8') as fh:
        logged = [line.strip() for line in fh if 'fps overall' in line]
    phase(f'{label}: cli extract {wall:.2f} s wall; logged: {logged[-1] if logged else "none"}; '
          f'launches {launches}; peak device memory {peak_gib:.2f} GiB [{card}]')
    for name, st in status['stage_stats'].items():
        phase(f'{label}: stage {name}: busy {st["busy_s"]} s, cpu {st["cpu_s"]} s, chunks '
              f'{st["chunks"]}' + (f', sub_times {st["sub_times"]}' if 'sub_times' in st else '')
              + f' [{card}]')
    per_k = 1000 / nframes
    for name in ('Preview Video', 'Preview Encode'):
        st = status['stage_stats'][name]
        phase(f'{label}: {name} per 1,000 frames: busy {st["busy_s"] * per_k:.3f} s, cpu '
              f'{st["cpu_s"] * per_k:.3f} s'
              + (', sub_times ' + ', '.join(f'{k} {v * per_k:.3f} s' for k, v in
                                            st['sub_times'].items()) if 'sub_times' in st else '')
              + f' [{card}]')
    check_avi(os.path.join(out_dir, 'results_00.avi'), nframes, card, label)
    return status, launches, wall, peak_gib


def serial_results(session, prepared: dict, predictor) -> dict:
    '''The session's chunks through ``extract.extract_chunks``, gathered as
    the results writer writes them (``written_rows``).'''
    from moseq2_detectron_extract_tpu_torch import extract
    results = {}
    for out in extract.extract_chunks(session, predictor, prepared):
        written_rows(out, prepared['first_frame_idx'], results)
        del out
    return results


def _expected_launches(nframes: int, chunk: int, batch: int) -> dict:
    chunks = -(-nframes // chunk)
    return {'roi_align': 3 * chunks * -(-chunk // batch), 'clean': chunks}


def check_extract(path: str, serial: dict, prepared: dict, card: str, seed: int,
                  model_dir: str, keep_h5: str) -> dict:
    '''Phase 4c: the ``extract`` command (``cli.main``, the CLI's defaults)
    (a) on phase 4b's session: the results file read back with the port's
    reader against phase 4b's serial ``extract_chunks`` results, dataset by
    dataset (and, where they differ, against a serial run with the CLI's
    batch size), its metadata against ``prepare_session``'s, the TSV and the
    instance log; (b) on a 4,000-frame session (4 chunks of 1000, no tail):
    frames/s, ``stage_stats``, peak memory and the file's size beside the
    serial path's frames/s. Returns (a)'s launches and its deterministic
    run's datasets and wall seconds (for phase 4h); (a)'s results file is
    copied to ``keep_h5`` for phase 4f, (b)'s to ``LONG_RESULTS`` beside it
    for phase 4g.'''
    import shutil
    import tempfile
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch import extract
    from moseq2_detectron_extract_tpu_torch.io import hdf5
    from moseq2_detectron_extract_tpu_torch.io.session import Session
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.synthetic import write_raw_session
    from moseq2_detectron_extract_tpu_torch.cli import extract_parser

    defaults = extract_parser().parse_args([path])
    cli_batch = defaults.batch_size
    tmp = tempfile.mkdtemp(prefix='m2de-extract-')
    try:
        out_a = os.path.join(tmp, 'a')
        status, launches, _, _ = _run_cli(path, model_dir, out_a, card, '4c (a)',
                                          SESSION_FRAMES)
        expect = _expected_launches(SESSION_FRAMES, defaults.chunk_size, cli_batch)
        if launches != expect:
            raise AssertionError(f'4c (a) launches {launches}, expected {expect}')
        h5_path = os.path.join(out_a, 'results_00.h5')
        shutil.copy(h5_path, keep_h5)
        differ = _compare_file(h5_path, serial)
        phase(f'4c (a): results_00.h5 against phase 4b\'s serial extract_chunks (batch '
              f'{BATCH}): {len(serial)} per-frame datasets, '
              + (f'{len(differ)} differ: {differ}' if differ else 'all equal bit for bit')
              + f' [{card}]')
        out_d = os.path.join(tmp, 'a-deterministic')
        try:
            torch.backends.cudnn.deterministic = True
            _, _, wall_d, _ = _run_cli(path, model_dir, out_d, card, '4c (a) deterministic',
                                       SESSION_FRAMES)
        finally:
            torch.backends.cudnn.deterministic = False
        dat_run = {'datasets': _datasets(os.path.join(out_d, 'results_00.h5')), 'wall': wall_d}
        if differ:
            # trace: is the card's forward repeatable, and does the file equal
            # the serial path once cuDNN runs deterministic algorithms?
            predictor = Predictor.from_model_dir(model_dir, batch_size=cli_batch,
                                                 score_threshold=defaults.instance_threshold)
            session = Session(path)
            again = extract.prepare_session(session, {'chunk_size': defaults.chunk_size},
                                            device='cuda')
            chunk = next(extract.produce_chunks(session, again))['chunk']
            for deterministic in (False, True):
                torch.backends.cudnn.deterministic = deterministic
                runs = [extract.process_chunk(chunk, predictor, again)['inference']
                        for _ in range(2)]
                gaps = {key: int((runs[0][key] != runs[1][key]).sum())
                        for key in ('boxes', 'scores', 'masks', 'keypoints')}
                kp_gap = float((runs[0]['keypoints'] - runs[1]['keypoints']).abs().max())
                phase(f'4c (a): chunk 0 through process_chunk twice (batch {cli_batch}, '
                      f'cudnn.deterministic {deterministic}): elements that differ {gaps}, '
                      f'keypoints max abs diff {kp_gap:.3e} [{card}]')
                del runs
            try:
                torch.backends.cudnn.deterministic = True
                results = serial_results(session, again, predictor)
            finally:
                torch.backends.cudnn.deterministic = False
            differ_d = _compare_file(os.path.join(out_d, 'results_00.h5'), results)
            phase(f'4c (a): with cudnn.deterministic, the file against a serial run at the '
                  f'CLI\'s batch size ({cli_batch}): ' + (f'{len(differ_d)} differ: {differ_d}'
                                                         if differ_d else
                                                         'all equal bit for bit') + f' [{card}]')
            if differ_d:
                raise AssertionError('the pipeline\'s file differs from the serial path with '
                                     'deterministic cuDNN at the same batch size')
        with hdf5.File(h5_path, 'r') as r:
            meta = {'timestamps': r['timestamps'][()],
                    'true_depth': r['metadata/extraction/true_depth'][()],
                    'roi': r['metadata/extraction/roi'][()],
                    'bground_im': r['metadata/extraction/background'][()],
                    'first_frame': r['metadata/extraction/first_frame'][()]}
            version = r['metadata/extraction/extract_version'][()]
        same = {k: bool(np.array_equal(v, np.asarray(prepared[k]))) for k, v in meta.items()}
        with open(os.path.join(out_a, 'keypoints_00.tsv'), encoding='utf-8') as fh:
            tsv_rows = sum(1 for _ in fh) - 1
        with open(os.path.join(out_a, 'instance_log.tsv'), encoding='utf-8') as fh:
            logged = {line.split('\t')[0] for line in list(fh)[1:]}
        phase(f'4c (a): metadata equal to prepare_session\'s {same}; {version}; keypoints TSV '
              f'{tsv_rows} rows, instance log {len(logged)} frames, status complete '
              f'{status["complete"]} [{card}]')
        if not all(same.values()) or tsv_rows != SESSION_FRAMES or len(logged) != SESSION_FRAMES:
            raise AssertionError('4c (a): metadata, TSV or instance log wrong')

        t = time.perf_counter()
        long_path = write_raw_session(os.path.join(tmp, 'long'), LONG_SESSION_FRAMES, 424, 512,
                                      seed=seed + 1)
        phase(f'4c (b): wrote {LONG_SESSION_FRAMES} frames of 424x512 '
              f'({os.path.getsize(long_path) / 1e9:.2f} GB) in {time.perf_counter() - t:.1f} s '
              f'[{card}]')
        out_b = os.path.join(tmp, 'b')
        status, launches_b, wall, peak = _run_cli(long_path, model_dir, out_b, card, '4c (b)',
                                                  LONG_SESSION_FRAMES)
        expect = _expected_launches(LONG_SESSION_FRAMES, defaults.chunk_size, cli_batch)
        if launches_b != expect:
            raise AssertionError(f'4c (b) launches {launches_b}, expected {expect}')
        h5_path = os.path.join(out_b, 'results_00.h5')
        raw_bytes = 0
        with hdf5.File(h5_path, 'r') as r:
            for _, ds in r.visit_datasets():
                if ds.shape is not None:
                    raw_bytes += int(np.prod(ds.shape, dtype=np.int64)) * ds.dtype.itemsize
            found = int(np.isfinite(r['scalars/centroid_x_px'][()]).sum())
        size = os.path.getsize(h5_path)
        shutil.copy(h5_path, os.path.join(os.path.dirname(keep_h5), LONG_RESULTS))
        phase(f'4c (b): {LONG_SESSION_FRAMES} frames at {LONG_SESSION_FRAMES / wall:.1f} '
              f'frames/s (cli wall, find_roi and model load included; the preview written, '
              f'which PR 14\'s 192.4 frames/s left out); results_00.h5 '
              f'{size / 1e6:.1f} MB of {raw_bytes / 1e6:.1f} MB uncompressed '
              f'({raw_bytes / size:.2f}x); centroid found in {found} frames [{card}]')

        predictor = Predictor.from_model_dir(model_dir, batch_size=cli_batch,
                                             score_threshold=defaults.instance_threshold)
        torch.cuda.synchronize()
        t = time.perf_counter()
        session = Session(long_path)
        prepared_b = extract.prepare_session(session, {'chunk_size': defaults.chunk_size},
                                             device='cuda')
        t_roi = time.perf_counter() - t
        frames = 0
        for out in extract.extract_chunks(session, predictor, prepared_b):
            frames += out['nframes']
            del out
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t
        phase(f'4c (b): serial extract_chunks (batch {cli_batch}) on the same session: {frames} '
              f'frames at {frames / serial_s:.1f} frames/s with find_roi ({t_roi:.2f} s), '
              f'{frames / (serial_s - t_roi):.1f} without; the pipeline through the writer '
              f'{LONG_SESSION_FRAMES / wall:.1f} [{card}]')
        return launches, dat_run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


TRAIN_VIEWS = 48                   # phase 4d: synthetic annotated views
TRAIN_VIEW_SIZE = 150              # fast160's train canvas scale (min_size_train 150)
TRAIN_STEPS = 60
RESUME_STEPS = 70
TRAIN_CHANGES = {'warmup_iters': 10, 'eval_period': 30, 'checkpoint_period': 30}
SPLIT_STEPS = 5
EXPORT_VIEWS = 16


def _train_rows(model_dir: str):
    with open(os.path.join(model_dir, 'metrics.jsonl'), encoding='utf-8') as fh:
        rows = [json.loads(line) for line in fh]
    return ([r for r in rows if 'total_loss' in r],
            [r for r in rows if 'validation_loss' in r])


def _tiny_train_config():
    '''The tiny model of the CPU parity tests (one block per stage, width
    16, FPN 64, f32) with their train-time proposal budget.'''
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
    return ModelConfig(image_size=64, min_size_test=64, max_size_test=64,
                       resnet_stage_blocks=(1, 1, 1, 1), resnet_width=16, fpn_channels=64,
                       box_fc_dim=128, mask_conv_dims=(64, 64), keypoint_conv_dims=(64, 64),
                       rpn_pre_nms_topk_test=64, rpn_post_nms_topk_test=32,
                       rpn_nms_global_cap=96, test_detections_per_image=2,
                       amp_dtype='float32', rpn_pre_nms_topk_train=200,
                       rpn_post_nms_topk_train=64, roi_batch_size_per_image=32,
                       max_gt_instances=2)


def _tiny_batch(cfg, b: int = 2, seed: int = 0):
    '''Normalized images (B, 3, S, S) and rectangle gts, from numpy.'''
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    s, g, k = cfg.image_size, cfg.max_gt_instances, cfg.num_keypoints
    images = rng.normal(0, 1, (b, 3, s, s)).astype('float32')
    masks = np.zeros((b, g, s, s), bool)
    boxes = np.zeros((b, g, 4), 'float32')
    kpts = np.zeros((b, g, k, 3), 'float32')
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(g if i == 0 else 1):
            x1, y1 = rng.integers(2, s // 2, 2)
            x2, y2 = x1 + rng.integers(12, s // 2), y1 + rng.integers(8, s // 3)
            masks[i, j, y1:y2, x1:x2] = True
            boxes[i, j] = (x1, y1, x2, y2)
            kpts[i, j, :, 0] = np.linspace(x1 + 1, x2 - 1, k)
            kpts[i, j, :, 1] = (y1 + y2) / 2
            kpts[i, j, :, 2] = 2.0
            valid[i, j] = True
    gt = {'boxes': boxes, 'valid': valid, 'masks': masks, 'keypoints': kpts}
    return torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in gt.items()}


def train_card_vs_cpu(card: str, seed: int) -> None:
    '''(c) One fixed batch and one fixed set of draws through the tiny
    model's losses and backward on the card and on the CPU (f32, TF32 off),
    and one augmented batch on both.'''
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch.models.augment import augment_batch, draw_augment
    from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN, draw_loss_uniforms
    from moseq2_detectron_extract_tpu_torch.models.train import create_train_state
    cfg = _tiny_train_config()
    cpu_state = create_train_state(cfg, seed=seed, device='cpu')
    card_model = MaskKeypointRCNN(cfg)
    card_model.load_state_dict(cpu_state.model.state_dict())
    card_model.cuda()
    images, gt = _tiny_batch(cfg, seed=seed)
    draws = draw_loss_uniforms(torch.Generator().manual_seed(seed), cfg, 2, 'cpu')
    out = {}
    for name, model, dev in (('cpu', cpu_state.model, 'cpu'), ('cuda', card_model, 'cuda')):
        mv = {k: v.to(dev) for k, v in gt.items()}
        dv = {k: tuple(u.to(dev) for u in pair) for k, pair in draws.items()}
        losses = model.losses(images.to(dev), mv, dv)
        losses['total_loss'].backward()
        out[name] = ({k: v.item() for k, v in losses.items()},
                     {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    (cpu_l, cpu_g), (gpu_l, gpu_g) = out['cpu'], out['cuda']
    loss_err = max(abs(gpu_l[k] - cpu_l[k]) / max(abs(cpu_l[k]), 1e-12) for k in cpu_l)
    # the heatmap deconv's bias has an exact gradient of 0 (softmax shift):
    # both hold rounding noise there
    grad_err = max(float((gpu_g[n] - cpu_g[n]).abs().max() / cpu_g[n].abs().max().clamp_min(1e-30))
                   for n in cpu_g if n != 'keypoint_head.score_lowres.bias')
    phase(f'4d (c) tiny model card vs CPU (f32, TF32 off): loss terms max rel err '
          f'{loss_err:.2e}, gradients max (abs err / max abs) {grad_err:.2e} (tolerance 1e-3 '
          f'each: index_add_ on the card scatters with atomics, in no fixed order) [{card}]')
    if loss_err > 1e-3 or grad_err > 1e-3:
        raise AssertionError(f'card vs CPU: losses {loss_err:.3e}, gradients {grad_err:.3e}')
    s = 150
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.uniform(0, 60, (4, s, s)).astype('float32'))
    masks = torch.zeros((4, 1, s, s), dtype=torch.bool)
    masks[:, 0, 50:90, 40:110] = True
    kpts = torch.zeros((4, 1, 8, 3))
    kpts[:, 0, :, 0] = torch.linspace(45, 105, 8)
    kpts[:, 0, :, 1] = 70.0
    kpts[:, 0, :, 2] = 2.0
    valid = torch.ones((4, 1), dtype=torch.bool)
    adraws = draw_augment(torch.Generator().manual_seed(seed), 4, s, 'cpu')

    def to(d, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in d.items()}
    res = {dev: augment_batch(to(adraws, dev), imgs.to(dev), masks.to(dev), kpts.to(dev),
                              valid.to(dev), cfg) for dev in ('cpu', 'cuda')}
    img_err = float((res['cuda'][0].cpu() - res['cpu'][0]).abs().max())
    mask_diff = int((res['cuda'][1]['masks'].cpu() != res['cpu'][1]['masks']).sum())
    phase(f'4d (c) augment_batch card vs CPU on 4 views of {s}x{s}: normalized images max '
          f'abs err {img_err:.2e}, mask pixels differing {mask_diff} [{card}]')


def train_step_split(cfg, items, card: str, seed: int, weights=None,
                     label: str = '4d (b)') -> None:
    '''(b) SPLIT_STEPS synchronised full-width steps, from ``weights`` (a
    state dict) or else from the flax-default init, split into augment,
    forward and losses (the gather ROIAlign's 3 calls and the proposal NMS
    timed apart inside it), backward and optimizer, every loss finite, with
    their iterations/s and peak device memory; then one step under
    torch.profiler (CUDA activity only).'''
    import torch
    from torch.profiler import ProfilerActivity, profile
    from moseq2_detectron_extract_tpu_torch.models import rcnn, rpn
    from moseq2_detectron_extract_tpu_torch.models.data import TrainLoader
    from moseq2_detectron_extract_tpu_torch.models.train import (apply_gradients,
                                                                 create_train_state)
    from moseq2_detectron_extract_tpu_torch.models.trainer import (augment_and_draw,
                                                                   batch_to_device)
    from moseq2_detectron_extract_tpu_torch.ops import nms

    state = create_train_state(cfg, seed=seed, device='cuda')
    if weights is not None:
        state.model.load_state_dict(weights, strict=True)
    loader = TrainLoader(items, cfg, seed=seed)
    gen = torch.Generator('cuda').manual_seed(seed)
    spent = {'roi_align': 0.0, 'nms': 0.0}
    pool, bnms = rcnn.MaskKeypointRCNN.train_pool, rpn.batched_nms_keep_mask

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return r
        return run

    def step(split=None):
        batch = batch_to_device(next(loader), 'cuda')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, gt, draws = augment_and_draw(batch, cfg, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses = state.model.losses(images, gt, draws)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses['total_loss'].backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        apply_gradients(state, cfg)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        bad = [k for k, v in losses.items() if not bool(torch.isfinite(v).all())]
        if bad:
            raise AssertionError(f'{label}: non-finite losses {bad} at step {state.step}')
        if split is not None:
            for key, dt in zip(('augment', 'forward_losses', 'backward', 'optimizer'),
                               (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                split[key].append(dt)
        return t4 - t0

    try:
        step()
        step()
        rcnn.MaskKeypointRCNN.train_pool = staticmethod(timed('roi_align', pool))
        rpn.batched_nms_keep_mask = timed('nms', bnms)
        split = {k: [] for k in ('augment', 'forward_losses', 'backward', 'optimizer')}
        nms.sync_count = 0
        torch.cuda.reset_peak_memory_stats()
        walls = [step(split) for _ in range(SPLIT_STEPS)]
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        syncs = nms.sync_count / SPLIT_STEPS
    finally:
        rcnn.MaskKeypointRCNN.train_pool = staticmethod(pool)
        rpn.batched_nms_keep_mask = bnms
    med = {k: statistics.median(v) * 1e3 for k, v in split.items()}
    phase(f'{label} step split, median of {SPLIT_STEPS} synchronised steps (batch '
          f'{cfg.ims_per_batch}, ms): ' + ', '.join(f'{k} {v:.2f}' for k, v in med.items())
          + f'; inside forward_losses, per step: gather ROIAlign (3 calls) '
          f'{spent["roi_align"] * 1e3 / SPLIT_STEPS:.2f}, train proposal NMS '
          f'{spent["nms"] * 1e3 / SPLIT_STEPS:.2f}; step wall median '
          f'{statistics.median(walls) * 1e3:.2f} ({1 / statistics.median(walls):.2f} it/s); NMS '
          f'host syncs per step {syncs:.1f}; peak device memory {peak_gib:.2f} GiB [{card}]')
    try:
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wall = step()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.device_time_total > 0]
            busy_us = sum(e.device_time_total for e in kernels)
            if busy_us > 0:
                break
        else:
            raise RuntimeError('the profiler recorded no device time in 3 traces')
    finally:
        loader.close()
    phase(f'{label} profiled step: wall {wall * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms '
          f'({100 * busy_us / 1e3 / (wall * 1e3):.1f}%), {sum(e.count for e in kernels)} '
          f'launches of {len(kernels)} kernel names [{card}]')
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:TOP_KERNELS]:
        print(f'  {e.device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}', flush=True)


def check_training(card: str, seed: int, model_dir: str, tmp: str):
    '''Phase 4d: (a) the train command at full width on a synthetic Label
    Studio export (written into ``tmp``, which the caller deletes), then
    resumed; (b) where a step's time goes; (c) the tiny model card against
    CPU; (d) the trained model's npz through ``Predictor``. Returns the
    ROIAlign launches of (d), and the export, the train config's path and
    the trained model dir (for phase 4e).'''
    import shutil
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch import cli
    from moseq2_detectron_extract_tpu_torch.io.annot import read_annotations
    from moseq2_detectron_extract_tpu_torch.io.image import read_image
    from moseq2_detectron_extract_tpu_torch.models.checkpoint import load_model_dir
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.models.weights import save_params_npz
    from moseq2_detectron_extract_tpu_torch.ops import roi_align_kernel
    from moseq2_detectron_extract_tpu_torch.proc.keypoints import default_keypoint_names
    from moseq2_detectron_extract_tpu_torch.synthetic import write_annotated_views

    t_phase = time.perf_counter()
    os.makedirs(tmp, exist_ok=True)
    t = time.perf_counter()
    export = write_annotated_views(os.path.join(tmp, 'data'), TRAIN_VIEWS,
                                   size=TRAIN_VIEW_SIZE, seed=seed)
    base = ModelConfig.from_yaml(os.path.join(model_dir, 'config.yaml'))
    cfg = base.replace(**TRAIN_CHANGES)
    cfg_path = os.path.join(tmp, 'config.yaml')
    cfg.to_yaml(cfg_path)
    phase(f'4d (a) wrote {TRAIN_VIEWS} annotated {TRAIN_VIEW_SIZE}x{TRAIN_VIEW_SIZE} views '
          f'and their export in {time.perf_counter() - t:.2f} s; config '
          f'{os.path.relpath(model_dir, REPO)}/config.yaml with '
          + ', '.join(f'{k} {getattr(base, k)} -> {v}' for k, v in TRAIN_CHANGES.items())
          + f' (amp {cfg.amp_dtype}, batch {cfg.ims_per_batch}, canvas {cfg.image_size}) '
          f'[{card}]')
    out_dir = os.path.join(tmp, 'model')
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cli.main(['train', export, '--model-dir', out_dir, '--config', cfg_path,
              '--max-iter', str(TRAIN_STEPS), '--log-period', '1'])
    train_s = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rows, val = _train_rows(out_dir)
    if [r['step'] for r in rows] != list(range(1, TRAIN_STEPS + 1)):
        raise AssertionError(f'logged steps {[r["step"] for r in rows]}')
    loss_keys = [k for k in rows[0] if k.startswith('loss_') or k == 'total_loss']
    if not all(np.isfinite(r[k]) for r in rows for k in loss_keys):
        raise AssertionError('a logged loss is not finite')
    first = float(np.mean([r['total_loss'] for r in rows[:10]]))
    last = float(np.mean([r['total_loss'] for r in rows[-10:]]))
    if not last < first:
        raise AssertionError(f'mean total_loss of the last 10 steps {last:.4f} is not below '
                             f'the first 10\'s {first:.4f}')
    ckpts = sorted(os.listdir(os.path.join(out_dir, 'checkpoints')))
    with open(os.path.join(out_dir, 'last_checkpoint'), encoding='utf-8') as fh:
        pointer = fh.read().strip()
    if pointer != f'model_{TRAIN_STEPS:07d}.pt' or pointer not in ckpts:
        raise AssertionError(f'checkpoints {ckpts}, last_checkpoint {pointer!r}')
    rates = [r['iters_per_sec'] for r in rows[5:]]
    it_s = statistics.median(rates)
    RATES['train_it_s'] = it_s
    phase(f'4d (a) cli train: {TRAIN_STEPS} steps in {train_s:.2f} s wall (annotation '
          f'loading, the validations and checkpoints included); {it_s:.2f} iterations/s, '
          f'{it_s * cfg.ims_per_batch:.1f} images/s (median after step 5); peak device '
          f'memory {peak_gib:.2f} GiB; mean total_loss first 10 {first:.4f}, last 10 '
          f'{last:.4f}; validation_loss {[round(v["validation_loss"], 4) for v in val]}; '
          f'checkpoints {ckpts} [{card}]')
    for label, row in (('first', rows[0]), ('last', rows[-1])):
        phase(f'4d (a) {label} step: ' + ', '.join(f'{k} {row[k]:.4f}' for k in loss_keys)
              + f', lr {row["lr"]:.6f} [{card}]')
    t = time.perf_counter()
    cli.main(['train', export, '--model-dir', out_dir, '--config', cfg_path,
              '--max-iter', str(RESUME_STEPS), '--resume', '--log-period', '1'])
    rows2, _ = _train_rows(out_dir)
    resumed = [r['step'] for r in rows2[len(rows):]]
    if resumed != list(range(TRAIN_STEPS + 1, RESUME_STEPS + 1)):
        raise AssertionError(f'resumed steps {resumed}')
    _, _, step = load_model_dir(out_dir)
    if step != RESUME_STEPS:
        raise AssertionError(f'the last checkpoint is at step {step}')
    phase(f'4d (a) --resume --max-iter {RESUME_STEPS}: continued at step {resumed[0]}, '
          f'ended at {step} in {time.perf_counter() - t:.2f} s; total_loss at '
          f'{RESUME_STEPS}: {rows2[-1]["total_loss"]:.4f} [{card}]')

    items = read_annotations(export, default_keypoint_names)
    train_step_split(cfg, items, card, seed)
    train_card_vs_cpu(card, seed)

    export_dir = os.path.join(tmp, 'export')
    os.makedirs(export_dir)
    shutil.copy(os.path.join(out_dir, 'config.yaml'), export_dir)
    trained_cfg, state, _ = load_model_dir(out_dir)
    save_params_npz(os.path.join(export_dir, 'params_f16.npz'), state,
                    trained_cfg.box_pooler_resolution)
    _, from_npz, _ = load_model_dir(export_dir)
    off = [k for k, v in state.items()
           if not torch.equal(from_npz[k], v.to(torch.float16).to(torch.float32))]
    if set(from_npz) != set(state) or off:
        raise AssertionError(f'the npz does not hold the f16 checkpoint weights: {off[:5]}')
    frames = np.stack([read_image(it['file_name']) for it in items[:EXPORT_VIEWS]]) \
        .astype(np.uint8)
    batch = 8
    predictor = Predictor.from_model_dir(export_dir, batch_size=batch, score_threshold=0.0)
    from_ckpt = Predictor.from_model_dir(out_dir, batch_size=batch, score_threshold=0.0)
    roi_align_kernel.launch_count = 0
    det = predictor(torch.from_numpy(frames))
    torch.cuda.synchronize()
    launches = roi_align_kernel.launch_count
    ref = from_ckpt(torch.from_numpy(frames))
    if launches != 3 * (EXPORT_VIEWS // batch):
        raise AssertionError(f'roi_align launches {launches}, expected '
                             f'{3 * (EXPORT_VIEWS // batch)}')
    for key in ('boxes', 'scores', 'keypoints', 'mask_probs'):
        if not bool(torch.isfinite(det[key]).all()):
            raise AssertionError(f'non-finite {key} from the exported model')
    score_gap = (det['scores'][:, 0] - ref['scores'][:, 0]).abs()
    score_err = float(score_gap.max())
    top_iou = box_iou_pairs(det['boxes'][:, 0], ref['boxes'][:, 0])
    phase(f'4d (d) params_f16.npz (save_params_npz): its {len(state)} tensors equal the '
          f'checkpoint\'s rounded to f16; through Predictor.from_model_dir on '
          f'{EXPORT_VIEWS} views: roi_align launches {launches}; top score median '
          f'{float(det["scores"][:, 0].median()):.3f}, against the f32 checkpoint\'s '
          f'top scores max abs diff {score_err:.2e} [{card}]')
    phase('4d (d) each view\'s top detection, npz against checkpoint: score gap / box IoU '
          + ', '.join(f'{g:.3f}/{u:.3f}' for g, u in zip(score_gap.tolist(), top_iou.tolist()))
          + f'; the same detection (IoU >= 0.9) in {int((top_iou >= 0.9).sum())} of '
          f'{len(top_iou)} views, min IoU {float(top_iou.min()):.3f} [{card}]')
    phase(f'4d: {time.perf_counter() - t_phase:.1f} s [{card}]')
    return {'roi_align': launches}, export, cfg_path, out_dir


def box_iou_pairs(a, b):
    '''IoU of each pair of rows of two (N, 4) [x0, y0, x1, y1] box tensors.'''
    import torch
    a, b = a.float().cpu(), b.float().cpu()
    w = (torch.minimum(a[:, 2], b[:, 2]) - torch.maximum(a[:, 0], b[:, 0])).clamp(min=0)
    h = (torch.minimum(a[:, 3], b[:, 3]) - torch.maximum(a[:, 1], b[:, 1])).clamp(min=0)
    inter = w * h
    area = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]) + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area - inter).clamp(min=1e-12)


ZOO_KEYPOINTS = 17                 # phase 4e: the COCO keypoint head of the zoo checkpoint
INIT_STEPS = 10                    # train --init-weights steps
EXPORT_BATCH = 10                  # compile-model's batch


EVAL_TASKS = ('bbox', 'segm', 'keypoints')


def eval_decisions(items, predictions, oks_sigmas) -> list:
    '''Per view, what ``models/eval.py:evaluate_predictions`` computes the
    AP from: the valid detections (their flags, boxes and scores) and, per
    task, their similarity to each ground truth and their areas, through
    that module's own helpers.'''
    import numpy as np
    from moseq2_detectron_extract_tpu_torch.models import eval as ev
    sigmas = np.asarray(oks_sigmas, float)
    out = []
    for item, pred in zip(items, predictions):
        gt_boxes, gt_masks, gt_kpts = ev._gt_from_item(item)
        valid = np.asarray(pred['valid'], bool)
        boxes = np.asarray(pred['boxes'], float)[valid]
        masks = [np.asarray(m, bool) for m in np.asarray(pred['masks'])[valid]]
        kpts = np.asarray(pred['keypoints'], float)[valid]
        g_area = np.asarray([m.sum() for m in gt_masks], float)
        kp_extent = ((kpts[:, :, 0].max(1) - kpts[:, :, 0].min(1))
                     * (kpts[:, :, 1].max(1) - kpts[:, :, 1].min(1))) if kpts.size \
            else np.zeros(len(boxes))
        out.append({
            'valid': valid, 'boxes': boxes, 'scores': np.asarray(pred['scores'], float)[valid],
            'sims': {'bbox': ev._box_iou_matrix(boxes, gt_boxes),
                     'segm': ev._mask_iou_matrix(masks, gt_masks),
                     'keypoints': ev._oks_matrix(kpts, gt_kpts, g_area, sigmas,
                                                 gt_boxes=gt_boxes)
                     if gt_kpts.size else np.zeros((len(boxes), 0))},
            'areas': {'bbox': np.prod(np.clip(boxes[:, 2:] - boxes[:, :2], 0, None), axis=1),
                      'segm': np.asarray([m.sum() for m in masks], float),
                      'keypoints': kp_extent}})
    return out


def decisions_differ(a: list, b: list) -> list:
    '''Where two ``eval_decisions`` lists lead the COCO evaluation apart:
    the valid flags of a view, the order of all scores (the precision-recall
    sweep and each view's matching order), a similarity on either side of a
    threshold, two similarities of one detection in the other order (which
    ground truth it takes), an area on either side of a range's edge. The
    evaluation decides from these alone, so where none differs the two give
    equal AP.'''
    import numpy as np
    from moseq2_detectron_extract_tpu_torch.models.eval import AREA_RANGES, IOU_THRESHOLDS
    if any(not np.array_equal(x['valid'], y['valid']) for x, y in zip(a, b)):
        return [f'view {i} valid' for i, (x, y) in enumerate(zip(a, b))
                if not np.array_equal(x['valid'], y['valid'])]
    out = []
    order = [np.argsort(-np.concatenate([v['scores'] for v in d]), kind='stable') for d in (a, b)]
    if not np.array_equal(*order):
        out.append('score order')
    for i, (x, y) in enumerate(zip(a, b)):
        for task in EVAL_TASKS:
            sx, sy = x['sims'][task], y['sims'][task]
            for t in IOU_THRESHOLDS:
                if np.any((sx >= min(t, 1 - 1e-10)) != (sy >= min(t, 1 - 1e-10))):
                    out.append(f'view {i} {task} at {t:.2f}')
            if not np.array_equal(np.sign(sx[:, :, None] - sx[:, None, :]),
                                  np.sign(sy[:, :, None] - sy[:, None, :])):
                out.append(f'view {i} {task} ground truth order')
            for label, (lo, hi) in AREA_RANGES.items():
                ax, ay = x['areas'][task], y['areas'][task]
                if np.any(((ax >= lo) & (ax <= hi)) != ((ay >= lo) & (ay <= hi))):
                    out.append(f'view {i} {task} area {label}')
    return out


def sim_gap(a: list, b: list, task: str) -> float:
    '''Largest similarity difference of a task over views of equal valid
    flags (nan where none).'''
    import numpy as np
    gaps = [float(np.abs(x['sims'][task] - y['sims'][task]).max()) for x, y in zip(a, b)
            if np.array_equal(x['valid'], y['valid']) and x['sims'][task].size]
    return max(gaps) if gaps else float('nan')


def _metrics_equal(a: dict, b: dict) -> bool:
    import math
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


def zoo_checkpoint(path: str, cfg, seed: int) -> dict:
    '''Write a Detectron2 ``keypoint_rcnn_R_50_FPN_3x`` checkpoint made
    from ``seed`` with numpy as the zoo's ``.pkl``: its names and shapes
    (R50 with FrozenBN, an FPN without norms whose convs carry biases, the
    RPN, the box head with person and background logits, the keypoint head
    of 17 COCO keypoints, no mask head). Returns the state.'''
    import pickle
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch.models.convert import detectron2_name_map
    from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
    with torch.device('meta'):
        shapes = {k: tuple(v.shape) for k, v in MaskKeypointRCNN(cfg).state_dict().items()}
    rng = np.random.default_rng(seed)
    state = {}
    for d2, name in detectron2_name_map():
        fpn = d2.startswith('backbone.fpn_')
        if '.mask_head.' in d2 or (fpn and '.norm.' in d2):
            continue
        shape = (cfg.fpn_channels,) if fpn and d2.endswith('.bias') else shapes.get(name)
        if shape is None:
            continue
        if 'score_lowres' in d2:
            shape = (shape[0], ZOO_KEYPOINTS) + shape[2:] if len(shape) == 4 else (ZOO_KEYPOINTS,)
        value = rng.normal(0, 0.01, shape)
        if d2.endswith('running_var'):
            value = np.abs(value) + 1.0
        state[d2] = value.astype(np.float32)
    with open(path, 'wb') as fh:
        pickle.dump({'model': state, '__author__': 'synthesized from a seed'}, fh, protocol=4)
    return state


def _nan_equal(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and torch.equal(torch.nan_to_num(a, nan=-7.0),
                                              torch.nan_to_num(b, nan=-7.0))


def check_lifecycle(card: str, seed: int, export: str, cfg_path: str, trained: str,
                    session_path: str, prepared: dict, tmp: str) -> int:
    '''Phase 4e, the model lifecycle through ``cli``: (a) convert-weights
    on a zoo-shaped checkpoint and train --init-weights; (b) evaluate on the
    card and on the CPU; (c) compile-model (export, the post-export
    evaluation) and the loaded program against the live model; (d)
    infer-dataset; (e) find-roi against prepare_session. Returns the
    ROIAlign launches of the phase (all of them on the card's path).'''
    import contextlib
    import io
    import random
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch import cli
    from moseq2_detectron_extract_tpu_torch.io.annot import dataset_catalog_get, read_annotations
    from moseq2_detectron_extract_tpu_torch.io.image import read_image
    from moseq2_detectron_extract_tpu_torch.models import deploy
    from moseq2_detectron_extract_tpu_torch.models.checkpoint import load_model_dir
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
    from moseq2_detectron_extract_tpu_torch.models.convert import convert_checkpoint
    from moseq2_detectron_extract_tpu_torch.models.eval import evaluate_model
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
    from moseq2_detectron_extract_tpu_torch.models.train import init_flax_defaults
    from moseq2_detectron_extract_tpu_torch.ops import roi_align_kernel
    from moseq2_detectron_extract_tpu_torch.proc.keypoints import default_keypoint_names

    t_phase = time.perf_counter()
    os.makedirs(tmp, exist_ok=True)
    cfg = ModelConfig.from_yaml(cfg_path)
    roi_align_kernel.launch_count = 0

    # (a) convert the zoo checkpoint, then train from it
    t = time.perf_counter()
    pkl = os.path.join(tmp, 'zoo.pkl')
    state = zoo_checkpoint(pkl, cfg, seed)
    write_s = time.perf_counter() - t
    converted = os.path.join(tmp, 'converted')
    printed = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(['convert-weights', pkl, '--model-dir', converted, '--config', cfg_path])
    convert_s = time.perf_counter() - t
    template = init_flax_defaults(MaskKeypointRCNN(cfg), torch.Generator().manual_seed(0))
    cpu_state, report = convert_checkpoint(pkl, template.state_dict())
    counts = {k: len(v) for k, v in report.items()}
    # the zoo's FPN has conv biases and no norms; it has no mask head
    expect = {'loaded': len(state) - 8 - 2, 'shape_mismatch': 2,
              'missing_in_source': 16 + 2 * (len(cfg.mask_conv_dims) + 2), 'unused': 0}
    line = (f'loaded {counts["loaded"]} tensors, {counts["shape_mismatch"]} kept '
            f'initialization (shape mismatch), {counts["unused"]} source keys unused')
    _, written, step = load_model_dir(converted)
    same = all(torch.equal(written[k], v) for k, v in cpu_state.items())
    phase(f'4e (a) convert-weights: a {len(state)}-tensor zoo-shaped .pkl '
          f'({os.path.getsize(pkl) / 1e6:.0f} MB, written in {write_s:.1f} s) converted in '
          f'{convert_s:.1f} s; report counts {counts}, the CPU converter\'s on the same file '
          f'{expect == counts}; printed {printed.getvalue().splitlines()[0]!r}; checkpoint step '
          f'{step}, equal to the CPU conversion {same} [{card}]')
    if rc != 0 or counts != expect or printed.getvalue().splitlines()[0] != line or not same \
            or step != 0:
        raise AssertionError(f'4e (a): convert-weights counts {counts}, expected {expect}')
    init_dir = os.path.join(tmp, 'init')
    t = time.perf_counter()
    cli.main(['train', export, '--model-dir', init_dir, '--config', cfg_path, '--max-iter',
              str(INIT_STEPS), '--init-weights', pkl, '--log-period', '1'])
    rows, _ = _train_rows(init_dir)
    loss_keys = [k for k in rows[0] if k.startswith('loss_') or k == 'total_loss']
    finite = all(np.isfinite(r[k]) for r in rows for k in loss_keys)
    phase(f'4e (a) train --init-weights: {len(rows)} steps in {time.perf_counter() - t:.2f} s; '
          f'total_loss {rows[0]["total_loss"]:.4f} -> {rows[-1]["total_loss"]:.4f}; every loss '
          f'finite {finite} [{card}]')
    if [r['step'] for r in rows] != list(range(1, INIT_STEPS + 1)) or not finite:
        raise AssertionError('4e (a): train --init-weights')

    # (b) evaluate phase 4d's model on its views' test split, card and CPU:
    # in the model's own bf16, then in f32, where the card is held to the CPU
    from moseq2_detectron_extract_tpu_torch.models import eval as eval_mod
    f32_dir = os.path.join(tmp, 'trained_f32')
    os.makedirs(f32_dir)
    ModelConfig.from_yaml(os.path.join(trained, 'config.yaml')).replace(
        amp_dtype='float32').to_yaml(os.path.join(f32_dir, 'config.yaml'))
    os.symlink(os.path.join(trained, 'checkpoints'), os.path.join(f32_dir, 'checkpoints'))
    shutil.copy(os.path.join(trained, 'last_checkpoint'), f32_dir)
    real_evaluate_predictions = eval_mod.evaluate_predictions
    results, seen = {}, {}
    for dtype, model_dir in (('bf16', trained), ('f32', f32_dir)):
        for device in ('cuda', 'cpu'):
            def capture(items, predictions, oks_sigmas, **kwargs):
                seen[dtype, device] = (list(items), predictions, oks_sigmas)
                return real_evaluate_predictions(items, predictions, oks_sigmas, **kwargs)

            random.seed(seed)
            eval_mod.evaluate_predictions = capture
            try:
                t = time.perf_counter()
                results[dtype, device] = cli.evaluate([export, '--model-dir', model_dir,
                                                       '--device', device])
            finally:
                eval_mod.evaluate_predictions = real_evaluate_predictions
            phase(f'4e (b) evaluate ({dtype}) --device {device} '
                  f'({time.perf_counter() - t:.2f} s): ' + '; '.join(
                      f'{task} ' + ', '.join(f'{k} {v:.3f}' for k, v in m.items())
                      for task, m in results[dtype, device].items()) + f' [{card}]')
    test_items = dataset_catalog_get('moseq_test')
    n_test = len(test_items)
    names = {key: [it['file_name'] for it in got[0]] for key, got in seen.items()}
    if any(v != [it['file_name'] for it in test_items] for v in names.values()):
        raise AssertionError(f'4e (b): the evaluations saw other test splits: {names}')
    for task, metrics in results['bf16', 'cpu'].items():
        for dtype in ('bf16', 'f32'):
            for device in ('cuda', 'cpu'):
                m = results[dtype, device][task]
                if set(m) != set(metrics) or not all(
                        v == -1.0 or 0.0 <= v <= 100.0 for v in m.values()):
                    raise AssertionError(f'4e (b): {dtype} {device} {task} metrics {m}')
    decisions = {key: eval_decisions(*got) for key, got in seen.items()}
    for dtype in ('bf16', 'f32'):
        card_d, cpu_d = decisions[dtype, 'cuda'], decisions[dtype, 'cpu']
        gap = max(abs(results[dtype, 'cuda'][task][k] - results[dtype, 'cpu'][task][k])
                  for task in results[dtype, 'cpu'] for k in results[dtype, 'cpu'][task])
        differ = decisions_differ(card_d, cpu_d)
        top = []
        for a, b in zip(card_d, cpu_d):
            if len(a['scores']) and len(b['scores']):
                iou = box_iou_pairs(torch.from_numpy(a['boxes'][:1]),
                                    torch.from_numpy(b['boxes'][:1]))
                top.append(f'box IoU {float(iou[0]):.4f} score diff '
                           f'{abs(float(a["scores"][0] - b["scores"][0])):.4f}')
            else:
                top.append(f'({len(a["scores"])} and {len(b["scores"])} valid)')
        phase(f'4e (b) {dtype}, {n_test} test views, card against CPU: largest AP difference '
              f'{gap:.3f} points; the decisions the AP is computed from (valid detections, '
              f'score order, similarity and area against each threshold) differ at '
              f'{len(differ)}: {differ[:8]}; largest similarity difference ' + ', '.join(
                  f'{task} {sim_gap(card_d, cpu_d, task):.2e}' for task in EVAL_TASKS)
              + '; the top detection per view: ' + ', '.join(top) + f' [{card}]')
    # f32: the detections agree as in the reference check, and the AP is a
    # function of the decisions alone, so where none differs it is equal
    card_d, cpu_d = decisions['f32', 'cuda'], decisions['f32', 'cpu']
    same_valid = all(np.array_equal(a['valid'], b['valid']) for a, b in zip(card_d, cpu_d))
    box_err = max((float(np.abs(a['boxes'] - b['boxes']).max()) for a, b in zip(card_d, cpu_d)
                   if same_valid and len(a['boxes'])), default=0.0)
    score_err = max((float(np.abs(a['scores'] - b['scores']).max())
                     for a, b in zip(card_d, cpu_d) if same_valid and len(a['scores'])),
                    default=0.0)
    differ = decisions_differ(card_d, cpu_d)
    equal = all(_metrics_equal(results['f32', 'cuda'][task], results['f32', 'cpu'][task])
                for task in EVAL_TASKS)
    phase(f'4e (b) f32: valid detections equal {same_valid}; boxes {box_err:.4f} px, scores '
          f'{score_err:.2e} apart (to 1 px and 1e-2); AP equal {equal}'
          + ('' if equal else f' (decisions differ at {differ})') + f' [{card}]')
    if not same_valid or box_err > 1.0 or score_err > 1e-2 or (not equal and not differ):
        raise AssertionError(f'4e (b): f32 card against CPU: valid equal {same_valid}, boxes '
                             f'{box_err} px, scores {score_err}, AP equal {equal} with no '
                             f'decision differing')

    # (c) export at batch 10, canvas 160, with the post-export evaluation
    export_dir = os.path.join(tmp, 'export')
    export_s = {}
    real_export = deploy.export_model

    def timed_export(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_export(*args, **kwargs)
        export_s['s'] = time.perf_counter() - t0
        return out

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    deploy.export_model = timed_export
    try:
        random.seed(seed)
        t = time.perf_counter()
        _, post = cli.compile_model([export, '--model-dir', trained, '--batch-size',
                                     str(EXPORT_BATCH), '--image-size', str(cfg.image_size),
                                     '--output', export_dir])
        compile_s = time.perf_counter() - t
        deploy.export_model = real_export
        live_eval = evaluate_model(trained, dataset_catalog_get('moseq_test'),
                                   batch_size=EXPORT_BATCH)
        t = time.perf_counter()
        program = deploy.load_exported_model(export_dir)
        load_s = time.perf_counter() - t
        live = Predictor.from_model_dir(trained, batch_size=EXPORT_BATCH)
        items = read_annotations(export, default_keypoint_names)
        frames = torch.from_numpy(np.stack([read_image(it['file_name'])
                                            for it in items[:EXPORT_BATCH]]).astype(np.uint8))
        before = roi_align_kernel.launch_count
        got = program(frames)
        torch.cuda.synchronize()
        program_launches = roi_align_kernel.launch_count - before
        ref = live(frames)
        torch.cuda.synchronize()
    finally:
        deploy.export_model = real_export
        torch.backends.cudnn.deterministic = deterministic
    differ = [k for k in ref if not _nan_equal(got[k], ref[k])]
    size = os.path.getsize(os.path.join(export_dir, deploy.PROGRAM_NAME))
    phase(f'4e (c) compile-model (batch {EXPORT_BATCH}, canvas {cfg.image_size}): export '
          f'{export_s["s"]:.2f} s wall, the command with the post-export evaluation '
          f'{compile_s:.2f} s; model.pt2 {size / 1e6:.1f} MB; torch.export.load '
          f'{load_s:.2f} s; on {EXPORT_BATCH} views with cudnn.deterministic the program\'s '
          f'{len(ref)} outputs against the live Predictor: '
          + (f'differ {differ}' if differ else 'all equal bit for bit')
          + f'; roi_align launches through the program {program_launches} (one batch); '
          f'post-export evaluation equal to the live one {post == live_eval} [{card}]')
    if differ or program_launches != 3 or post != live_eval:
        raise AssertionError(f'4e (c): outputs {differ}, launches {program_launches}, '
                             f'post-export {post} against live {live_eval}')

    # (d) pre-annotate the views
    pre_path = os.path.join(tmp, 'predictions.json')
    t = time.perf_counter()
    rc = cli.main(['infer-dataset', export, '--model-dir', trained, '--output', pre_path,
                   '--instance-threshold', '0.0'])
    pre_s = time.perf_counter() - t
    with open(pre_path, encoding='utf-8') as fh:
        tasks = json.load(fh)
    kinds = [r['type'] for task in tasks for r in task['predictions'][0]['result']]
    polygons, keypoints = kinds.count('polygonlabels'), kinds.count('keypointlabels')
    phase(f'4e (d) infer-dataset --instance-threshold 0.0 on {len(tasks)} views: '
          f'{pre_s * 1e3 / len(tasks):.1f} ms per image (the command\'s wall, model load '
          f'included); {polygons} polygons and {keypoints} keypoints written; the JSON loads '
          f'[{card}]')
    if rc != 0 or len(tasks) != TRAIN_VIEWS or keypoints != 8 * TRAIN_VIEWS or polygons < 1:
        raise AssertionError(f'4e (d): {len(tasks)} tasks, {polygons} polygons, '
                             f'{keypoints} keypoints')

    # (e) find-roi on phase 4b's session
    t = time.perf_counter()
    session = cli.find_roi([session_path, '--output-dir', os.path.join(tmp, 'roi')])
    roi_s = time.perf_counter() - t
    same = {'roi': bool(np.array_equal(session.roi, prepared['roi'])),
            'bground_im': bool(np.array_equal(session.bground_im, prepared['bground_im'])),
            'true_depth': session.true_depth == prepared['true_depth']}
    phase(f'4e (e) find-roi on phase 4b\'s session: {roi_s:.2f} s; equal to prepare_session\'s '
          f'{same}; true depth {session.true_depth} [{card}]')
    if not all(same.values()):
        raise AssertionError('4e (e): find-roi differs from prepare_session')

    launches = roi_align_kernel.launch_count
    expect_launches = 3 * (n_test + n_test + n_test + n_test + 1 + 1 + TRAIN_VIEWS)
    phase(f'4e: roi_align launches {launches} (expected {expect_launches}: 3 per image of the '
          f'card\'s bf16 and f32 evaluations, the post-export and the live evaluation and the '
          f'pre-annotation, and per batch of the program check); '
          f'{time.perf_counter() - t_phase:.1f} s [{card}]')
    if launches != expect_launches:
        raise AssertionError(f'4e: roi_align launches {launches}, expected {expect_launches}')
    return launches


REVERSE_FRAMES = 200               # phase 4f: crops put back, card against CPU


def check_preview_commands(card: str, session_path: str, results_h5: str, tmp: str) -> None:
    '''Phase 4f: ``visualize-raw`` on the session and ``visualize-result``
    on the results file, timed, their AVIs checked (``check_avi``); then
    ``reverse_crop_and_rotate_frames`` on the card against the CPU.'''
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch import cli
    from moseq2_detectron_extract_tpu_torch.io import hdf5
    from moseq2_detectron_extract_tpu_torch.ops.warp import reverse_crop_and_rotate_frames
    os.makedirs(tmp)
    for command, source, name in (('visualize-raw', session_path, 'raw.avi'),
                                  ('visualize-result', results_h5, 'result.avi')):
        out = os.path.join(tmp, name)
        t = time.perf_counter()
        if cli.main([command, source, '-o', out]) != 0:
            raise AssertionError(f'{command} failed')
        seconds = time.perf_counter() - t
        phase(f'4f {command}: {SESSION_FRAMES} frames in {seconds:.2f} s, '
              f'{SESSION_FRAMES / seconds:.1f} frames/s [{card}]')
        check_avi(out, SESSION_FRAMES, card, f'4f {command}')
    with hdf5.File(results_h5, 'r') as h5:
        frames = h5['frames'][0:REVERSE_FRAMES].astype('float32')
        centers = np.stack([h5['scalars/centroid_x_px'][0:REVERSE_FRAMES],
                            h5['scalars/centroid_y_px'][0:REVERSE_FRAMES]], axis=1)
        angles = np.rad2deg(h5['scalars/angle'][0:REVERSE_FRAMES])
        roi = h5['metadata/extraction/roi'][()]
    ys, xs = np.nonzero(roi > 0)
    dest = (int(xs.max() - xs.min()), int(ys.max() - ys.min()))
    torch.cuda.synchronize()
    t = time.perf_counter()
    card_out = reverse_crop_and_rotate_frames(torch.from_numpy(frames).cuda(), centers, angles,
                                              dest)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t) * 1e3
    cpu_out = reverse_crop_and_rotate_frames(torch.from_numpy(frames), centers, angles, dest)
    err = float((card_out.cpu() - cpu_out).abs().max())
    phase(f'4f reverse_crop_and_rotate_frames: {REVERSE_FRAMES} crops into {dest[0]}x{dest[1]} '
          f'in {card_ms:.2f} ms on the card (first call); card vs CPU max abs err {err:.2e} '
          f'[{card}]')
    if not err <= 1e-3:
        raise AssertionError(f'reverse_crop_and_rotate_frames: card vs CPU {err}')


TRIM = (100, 1100)                 # phase 4g: trim-result's --start and --stop
FLIP_RANGES = ((100, 400), (1000, 1010), (2500, 3999))   # phase 4g: manual-flip's ranges
REPORT_TRIM = (0, 800)             # phase 4g: extract --report-outliers on 300 frames


def _ranges_text(indices) -> str:
    '''Frame indices as a report writes them: one inclusive range a line.'''
    lines, start = [], None
    for i, idx in enumerate(indices):
        if start is None:
            start = idx
        if i + 1 == len(indices) or indices[i + 1] != idx + 1:
            lines.append(f'{start}-{idx}\n' if idx != start else f'{start}\n')
            start = None
    return ''.join(lines)


def outlier_reports(h5_path: str) -> dict:
    '''The three reports of ``find_outliers_h5`` recomputed from the file
    with numpy: frames with a NaN keypoint; frames where a keypoint but the
    tail tip lies more than 10 modified z-scores (0.6745 x its distance over
    the median distance) from its trailing 4-frame median; frames where the
    flips change.'''
    import numpy as np
    from moseq2_detectron_extract_tpu_torch.io import hdf5
    names = ('Nose', 'Left Ear', 'Right Ear', 'Neck', 'Left Hip', 'Right Hip', 'TailBase',
             'TailTip')
    with hdf5.File(h5_path, 'r') as h5:
        kp = np.stack([np.stack([h5[f'keypoints/reference/{n}_{c}'][()]
                                 for c in ('x_px', 'y_px', 'score')], -1) for n in names], 1)
        flips = h5['metadata/extraction/flips'][()]
    kp = kp.astype(float)
    xy = kp[:, :-1, :2]
    window = min(4, len(xy))
    med = np.empty_like(xy)
    for i in range(window - 1):
        med[i] = np.median(xy[:i + 1], axis=0)
    med[window - 1:] = np.median(np.lib.stride_tricks.sliding_window_view(xy, window, axis=0),
                                 axis=-1)
    dist = np.sqrt(((xy - med) ** 2).sum(-1))
    diff = np.abs(np.nan_to_num(dist - np.nanmedian(dist, axis=0)))
    with np.errstate(divide='ignore', invalid='ignore'):
        jumping = (0.6745 * diff / np.median(diff, axis=0) > 10).any(axis=1)
    return {'nan_keypoints': np.flatnonzero(np.isnan(kp).any(axis=(1, 2))),
            'jumping_keypoints': np.flatnonzero(jumping),
            'flips': np.flatnonzero(np.diff(flips.astype(int))) + 1}


def check_reports(h5_path: str) -> dict:
    '''Each report beside the results file names the frames of
    ``outlier_reports``; returns how many each names.'''
    counts = {}
    for name, frames in outlier_reports(h5_path).items():
        with open(f'{os.path.splitext(h5_path)[0]}.{name}.txt', encoding='utf-8') as fh:
            got = fh.read()
        if got != _ranges_text(frames):
            raise AssertionError(f'{name} report of {h5_path} differs from numpy\'s: '
                                 f'{got[:200]!r} against {_ranges_text(frames)[:200]!r}')
        counts[name] = len(frames)
    return counts


def _datasets(h5_path: str) -> dict:
    from moseq2_detectron_extract_tpu_torch.io import hdf5
    with hdf5.File(h5_path, 'r') as h5:
        return {name: (ds[()], dict(ds.attrs)) for name, ds in h5.visit_datasets()}


def _same(a, b) -> bool:
    import numpy as np
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind == 'f')
    return type(a) is type(b) and (repr(a) == repr(b))


def check_result_upkeep(card: str, long_h5: str, session_path: str, export: str,
                        model_dir: str, tmp: str) -> None:
    '''Phase 4g: the result upkeep through ``cli`` on phase 4c (b)'s
    results file (copies in ``tmp``), each step timed: ``find-outliers``
    (its reports against ``outlier_reports``), ``trim-result`` (the trimmed
    datasets against the backup's rows, the rest untouched), ``manual-flip``
    twice (frames, masks and flips back bit for bit, ``flips_1`` and
    ``flips_2`` kept), ``verify-flips`` (0, then 1 on overlapping ranges),
    ``generate-extract-config`` (read back through ``--config-file``),
    ``dataset-info`` on phase 4d's views, ``system-info`` (it must name the
    card) and ``extract --report-outliers`` on 300 frames of phase 4b's
    session.'''
    import contextlib
    import io
    import numpy as np
    from moseq2_detectron_extract_tpu_torch import cli
    from moseq2_detectron_extract_tpu_torch.io.options import apply_config_file
    from moseq2_detectron_extract_tpu_torch.io.util import read_yaml
    os.makedirs(tmp)
    t_phase = time.perf_counter()

    def run(label: str, argv, expect_rc: int = 0) -> float:
        t = time.perf_counter()
        rc = cli.main(list(argv))
        seconds = time.perf_counter() - t
        if rc != expect_rc:
            raise AssertionError(f'4g {label}: exit code {rc}, expected {expect_rc}')
        return seconds

    work = os.path.join(tmp, 'results_00.h5')
    shutil.copy(long_h5, work)
    seconds = run('find-outliers', ['find-outliers', work])
    counts = check_reports(work)
    phase(f'4g find-outliers on {LONG_SESSION_FRAMES} frames: {seconds:.2f} s; the three '
          f'reports equal numpy\'s recomputation (frames: {counts}) [{card}]')

    original = _datasets(long_h5)
    seconds = run('trim-result', ['trim-result', work, '--start', str(TRIM[0]),
                                  '--stop', str(TRIM[1])])
    trimmed, backup = _datasets(work), _datasets(work + '.bak')
    cut = [n for n in backup if ('flips' in n or 'metadata' not in n)
           and np.ndim(backup[n][0]) and len(backup[n][0]) >= TRIM[1]]
    bad = [n for n in backup if not _same(trimmed[n][0], backup[n][0][TRIM[0]:TRIM[1]]
                                          if n in cut else backup[n][0])
           or trimmed[n][1] != backup[n][1]]
    if sorted(trimmed) != sorted(backup) or bad or len(cut) < 100:
        raise AssertionError(f'4g trim-result: datasets that differ {bad[:5]}')
    phase(f'4g trim-result --start {TRIM[0]} --stop {TRIM[1]}: {seconds:.2f} s; {len(cut)} '
          f'datasets equal rows {TRIM[0]}-{TRIM[1] - 1} of the backup, the other '
          f'{len(backup) - len(cut)} (metadata) untouched; {os.path.getsize(work) / 1e6:.1f} MB '
          f'of {os.path.getsize(work + ".bak") / 1e6:.1f} MB [{card}]')

    flipped = os.path.join(tmp, 'flipped', 'results_00.h5')
    os.makedirs(os.path.dirname(flipped))
    shutil.copy(long_h5, flipped)
    flips_txt = os.path.join(tmp, 'flips.txt')
    with open(flips_txt, 'w', encoding='utf-8') as fh:
        fh.write('# frames to turn\n' + ''.join(f'{a}-{b}\n' for a, b in FLIP_RANGES))
    flip_s = [run('manual-flip', ['manual-flip', flipped, flips_txt]) for _ in range(2)]
    after = _datasets(flipped)
    back = [n for n in ('/frames', '/frames_mask', '/metadata/extraction/flips')
            if not _same(after[n][0], original[n][0])]
    layers = sorted(n for n in after if n.startswith('/metadata/extraction/flips_'))
    if back or layers != [f'/metadata/extraction/flips_{i}' for i in range(3)] or \
            not _same(after['/metadata/extraction/flips_0'][0],
                      original['/metadata/extraction/flips'][0]):
        raise AssertionError(f'4g manual-flip twice: {back} not back; layers {layers}')
    once = sum(b - a for a, b in FLIP_RANGES)
    phase(f'4g manual-flip twice ({once} frames each): {flip_s[0]:.2f} s and '
          f'{flip_s[1]:.2f} s; frames, masks and flips back bit for bit, layers '
          f'{[n.rsplit("/", 1)[1] for n in layers]} [{card}]')

    overlap = os.path.join(tmp, 'overlap.txt')
    with open(overlap, 'w', encoding='utf-8') as fh:
        fh.write('0-100\n50-60\n')
    seconds = run('verify-flips', ['verify-flips', flips_txt]) + \
        run('verify-flips', ['verify-flips', overlap], expect_rc=1)
    phase(f'4g verify-flips: exit code 0 on the flips file, 1 on overlapping ranges '
          f'({seconds:.3f} s) [{card}]')

    config = os.path.join(tmp, 'extract-config.yaml')
    seconds = run('generate-extract-config', ['generate-extract-config', '-o', config])
    parser = cli.extract_parser()
    defaults = vars(parser.parse_args([session_path]))
    argv = [session_path, '--config-file', config]
    args = parser.parse_args(argv)
    apply_config_file(parser, args, argv)
    if dict(vars(args), config_file=None) != defaults:
        raise AssertionError('4g: the generated config does not read back to the defaults')
    phase(f'4g generate-extract-config: {seconds:.3f} s; {len(read_yaml(config))} keys, read '
          f'back through --config-file to the defaults [{card}]')

    seconds = run('dataset-info', ['dataset-info', export])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        seconds_info = run('system-info', ['system-info'])
    import torch
    name = torch.cuda.get_device_name(0)
    if name not in out.getvalue():
        raise AssertionError(f'4g system-info does not name the card: {out.getvalue()!r}')
    phase(f'4g dataset-info on phase 4d\'s views: {seconds:.2f} s; system-info '
          f'{seconds_info:.2f} s: ' + '; '.join(out.getvalue().splitlines()) + f' [{card}]')

    report_out = os.path.join(tmp, 'report')
    seconds = run('extract --report-outliers',
                  ['extract', session_path, '--model', model_dir, '--output-dir', report_out,
                   '--frame-trim', *map(str, REPORT_TRIM), '--report-outliers'])
    if read_yaml(os.path.join(report_out, 'results_00.yaml'))['complete'] is not True:
        raise AssertionError('4g extract --report-outliers did not complete')
    counts = check_reports(os.path.join(report_out, 'results_00.h5'))
    nframes = SESSION_FRAMES - sum(REPORT_TRIM)
    phase(f'4g extract --report-outliers on {nframes} frames: {seconds:.2f} s, reports equal '
          f'numpy\'s (frames: {counts}) [{card}]')
    phase(f'4g: {time.perf_counter() - t_phase:.1f} s [{card}]')


CONVERT_THREADS = 3                # phase 4h (a): convert-raw-to-avi -t (its default)
KMEANS_SAMPLES = 50                # phase 4h (c): generate-dataset --num-samples
LIST_FRAMES = '0,17,250,999,1099'  # phase 4h (c): generate-dataset --frame-indices


def _tasks_frames(out_dir: str) -> list:
    with open(os.path.join(out_dir, 'tasks.json'), encoding='utf-8') as fh:
        return sorted(t['data']['frame_index'] for t in json.load(fh))


def check_compressed(card: str, session_path: str, dat_run: dict, model_dir: str,
                     tmp: str) -> dict:
    '''Phase 4h: ``convert-raw-to-avi`` on phase 4b's session and the
    libavcodec fixture; ``extract`` on the ``.avi`` against phase 4c (a)'s
    deterministic run on the ``.dat`` (``dat_run``); ``generate-dataset`` on
    both. Returns the ``.avi`` extract's launches.'''
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch import cli, dataset
    from moseq2_detectron_extract_tpu_torch.io import ffv1, video
    from moseq2_detectron_extract_tpu_torch.io.session import Session
    from moseq2_detectron_extract_tpu_torch.synthetic import codec_fixture_frames
    os.makedirs(tmp, exist_ok=True)

    # (a) the round trip, the encode and the verify decode timed apart
    timers = {'write_frames': 0.0, 'read_frames': 0.0}
    originals = {name: getattr(video, name) for name in timers}

    def timed(name):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return originals[name](*args, **kwargs)
            finally:
                timers[name] += time.perf_counter() - t
        return run
    for name in timers:
        setattr(video, name, timed(name))
    try:
        t = time.perf_counter()
        avi_path = os.path.join(os.path.dirname(session_path), 'depth.avi')
        rc = cli.main(['convert-raw-to-avi', session_path, '-o', avi_path, '-t',
                       str(CONVERT_THREADS)])
        wall = time.perf_counter() - t
    finally:
        for name, fn in originals.items():
            setattr(video, name, fn)
    if rc != 0:
        raise AssertionError(f'4h (a): convert-raw-to-avi returned {rc}')
    reader = ffv1.Ffv1Reader(avi_path)
    raw_bytes, avi_bytes = os.path.getsize(session_path), os.path.getsize(avi_path)
    cfg = reader.config
    phase(f'4h (a) convert-raw-to-avi on {SESSION_FRAMES} frames of 424x512: {wall:.2f} s wall '
          f'(verify pass included); encode {SESSION_FRAMES / timers["write_frames"]:.1f} '
          f'frames/s, verify decode {SESSION_FRAMES / timers["read_frames"]:.1f} frames/s '
          f'({cfg["num_h"]}x{cfg["num_v"]} slices, version {cfg["version"]}, ec {cfg["ec"]}; '
          f'{CONVERT_THREADS} threads each); AVI {avi_bytes / 1e6:.1f} MB against the raw '
          f'{raw_bytes / 1e6:.1f} MB ({raw_bytes / avi_bytes:.2f}x smaller), keyframes '
          f'{int(reader.index.keyframes.sum())} [{card}]')
    fixture = os.path.join(REPO, 'tests', 'data', 'ffv1_libavcodec_130x106.avi')
    expect = codec_fixture_frames()
    t = time.perf_counter()
    got = ffv1.Ffv1Reader(fixture).read()
    fixture_s = time.perf_counter() - t
    same = got.shape == expect.shape and bool(np.array_equal(got, expect))
    phase(f'4h (a) the libavcodec fixture ({os.path.getsize(fixture)} bytes, '
          f'{len(expect)} frames of 130x106): decoded in {fixture_s * 1e3:.1f} ms, bit for bit '
          f'equal to codec_fixture_frames(): {same} [{card}]')
    if not same:
        raise AssertionError('the port decodes the libavcodec fixture wrong')

    # (b) extract on the .avi against phase 4c (a)'s .dat run, deterministic cuDNN
    from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, roi_align_kernel
    try:
        torch.backends.cudnn.deterministic = True
        _, launches, wall_avi, _ = _run_cli(avi_path, model_dir, os.path.join(tmp, 'avi'), card,
                                            '4h (b) .avi', SESSION_FRAMES)
    finally:
        torch.backends.cudnn.deterministic = False
    ours = _datasets(os.path.join(tmp, 'avi', 'results_00.h5'))
    ref, wall_dat = dat_run['datasets'], dat_run['wall']
    # the file names and the run's uuid differ by design; the first frame is
    # stored as read, int16 from a .dat and uint16 from an .avi (as the JAX
    # package stores it)
    differ_by_design = {'/metadata/extraction/parameters/input_file',
                        '/metadata/extraction/parameters/output_dir', '/metadata/uuid'}
    as_read = {'/metadata/extraction/first_frame'}

    def values_equal(a, b):
        if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
            return a.shape == b.shape and bool(np.array_equal(
                a, b, equal_nan=a.dtype.kind == 'f' and b.dtype.kind == 'f'))
        return _same(a, b)
    differ = sorted(k for k in set(ref) | set(ours) if k not in differ_by_design and (
        k not in ref or k not in ours or not values_equal(ref[k][0], ours[k][0])
        or (k not in as_read and not _same(ref[k][0], ours[k][0]))))
    dtypes = {k: (str(ref[k][0].dtype), str(ours[k][0].dtype)) for k in sorted(as_read)}
    phase(f'4h (b) extract on the .avi: {SESSION_FRAMES / wall_avi:.1f} frames/s, on the .dat '
          f'(phase 4c (a)) {SESSION_FRAMES / wall_dat:.1f} frames/s (cli wall, '
          f'cudnn.deterministic); '
          f'{len(ref)} datasets, ' + (f'{len(differ)} differ: {differ[:8]}' if differ else
                                     'all equal bit for bit but the names and the uuid')
          + f' (dtypes as read, .dat and .avi: {dtypes}); launches {launches} [{card}]')
    if differ:
        raise AssertionError(f'4h (b): the .avi results differ from the .dat results: {differ}')
    if roi_align_kernel.launch_count == 0 or clean_kernel.launch_count == 0:
        raise AssertionError('4h (b): the .avi extract launched no kernel')

    # (c) generate-dataset on both files
    picks, seconds = {}, {}
    for label, path in (('dat', session_path), ('avi', avi_path)):
        out = os.path.join(tmp, f'gen-{label}')
        t = time.perf_counter()
        if cli.main(['generate-dataset', path, '--output-dir', out, '--sample-method', 'kmeans',
                     '--num-samples', str(KMEANS_SAMPLES)]) != 0:
            raise AssertionError(f'4h (c): generate-dataset on the .{label} failed')
        torch.cuda.synchronize()
        seconds[f'kmeans .{label}'] = time.perf_counter() - t
        picks[label] = _tasks_frames(out)
    for method, extra in (('uniform', []), ('list', ['--frame-indices', LIST_FRAMES])):
        out = os.path.join(tmp, f'gen-{method}')
        t = time.perf_counter()
        if cli.main(['generate-dataset', avi_path, '--output-dir', out, '--sample-method', method,
                     '--num-samples', str(KMEANS_SAMPLES), *extra]) != 0:
            raise AssertionError(f'4h (c): generate-dataset {method} failed')
        seconds[method] = time.perf_counter() - t
        got = _tasks_frames(out)
        want = sorted(int(i) for i in LIST_FRAMES.split(',')) if method == 'list' else \
            list(range(0, SESSION_FRAMES, SESSION_FRAMES // KMEANS_SAMPLES))[:KMEANS_SAMPLES]
        if got != want:
            raise AssertionError(f'4h (c) {method}: frames {got[:8]}..., expected {want[:8]}...')
    session = Session(session_path)
    session.find_roi()     # computed afresh, as the command's first run found it
    data, idxs = dataset.kmeans_features(session, 0, 100)
    t = time.perf_counter()
    card_picks = dataset.pick_frames_kmeans(data, idxs, KMEANS_SAMPLES)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    data_cpu = data.cpu()
    t = time.perf_counter()
    cpu_picks = dataset.pick_frames_kmeans(data_cpu, idxs, KMEANS_SAMPLES)
    cpu_s = time.perf_counter() - t

    def cost(frames):
        chosen = data_cpu[torch.as_tensor(np.searchsorted(idxs, frames))].double()
        return float(torch.cdist(data_cpu.double(), chosen).min(dim=1).values.pow(2).sum())
    if cpu_picks == card_picks:
        versus = 'equal to the CPU run\'s'
    else:
        ratio = cost(card_picks) / cost(cpu_picks)
        versus = (f'{len(set(card_picks) ^ set(cpu_picks))} differ from the CPU run\'s by float '
                  f'order; cost {ratio:.6f} of the CPU picks\'')
        if abs(ratio - 1) >= 0.01:
            raise AssertionError(f'4h (c): the card\'s k-means picks cost {ratio} of the CPU\'s')
    phase(f'4h (c) generate-dataset kmeans ({KMEANS_SAMPLES} of {len(idxs)} frames, '
          f'{data.shape[1]} features): picks on the .dat and the .avi '
          + ('the same' if picks['dat'] == picks['avi'] else 'DIFFER')
          + f'; the k-means alone on the card {card_s:.2f} s, on the CPU {cpu_s:.2f} s, the '
          f'card\'s picks {versus}; seconds ' + ', '.join(f'{k} {v:.2f}' for k, v in
                                                       seconds.items()) + f' [{card}]')
    if picks['dat'] != picks['avi'] or picks['dat'] != card_picks:
        raise AssertionError(f'4h (c): picks .dat {picks["dat"][:6]}..., .avi '
                             f'{picks["avi"][:6]}..., kmeans_features {card_picks[:6]}...')
    return launches


DP_STEPS = 5                       # phase 4i (a): data-parallel steps at world 1
DP_BATCH = 8                       # their batch
BATCH_TRIM = (0, 800)              # phase 4i (c): --frame-trim, 300 of 1,100 frames a session
OFFPATH_FRAMES = 16                # phase 4i (d): frames of the off-path ops, card vs CPU


def check_dp_world1(card: str, seed: int, export: str, cfg_path: str, tmp: str) -> None:
    """4i (a): ``make_dp_train_step`` at world 1 over NCCL (a ``FileStore``
    in ``tmp``) against the Trainer's step, DP_STEPS steps each of fast160
    at batch DP_BATCH on phase 4d's views, the same loader batches and a
    generator seeded alike, with deterministic algorithms: the parameters
    and the losses must be equal bit for bit."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from moseq2_detectron_extract_tpu_torch.io.annot import read_annotations
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig
    from moseq2_detectron_extract_tpu_torch.models.data import TrainLoader
    from moseq2_detectron_extract_tpu_torch.models.train import (create_train_state,
                                                                 make_train_step)
    from moseq2_detectron_extract_tpu_torch.models.trainer import (augment_and_draw,
                                                                   batch_to_device)
    from moseq2_detectron_extract_tpu_torch.parallel import (make_dp_train_step, make_mesh,
                                                            replicate_state, shard_batch)
    from moseq2_detectron_extract_tpu_torch.proc.keypoints import default_keypoint_names

    cfg = ModelConfig.from_yaml(cfg_path)
    loader = TrainLoader(read_annotations(export, default_keypoint_names), cfg,
                         batch_size=DP_BATCH, seed=seed)
    try:
        host = [next(loader) for _ in range(DP_STEPS)]
    finally:
        loader.close()
    # NCCL's bootstrap on the loopback device: world 1 on one machine
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    os.environ.setdefault('NCCL_IB_DISABLE', '1')
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t = time.perf_counter()
        mesh = make_mesh(0, 1, 'cuda', store_path=os.path.join(tmp, 'dp-store'))
        init_s = time.perf_counter() - t

        def run(step, state, batch_of):
            seconds, metrics = [], None
            gen = torch.Generator('cuda').manual_seed(seed + 1)
            for hb in host:
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, metrics = step(state, batch_of(hb), gen)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t)
            return state, metrics, seconds

        train_step = make_train_step(cfg)

        def trainer_step(state, batch, gen):
            images, gt, draws = augment_and_draw(batch, cfg, gen)
            return train_step(state, {'images': images, 'gt': gt}, draws)

        ref, ref_metrics, ref_s = run(trainer_step, create_train_state(cfg, seed=seed),
                                      lambda hb: batch_to_device(hb, mesh.device))
        state, metrics, dp_s = run(make_dp_train_step(cfg, mesh),
                                   replicate_state(mesh, create_train_state(cfg, seed=seed)),
                                   lambda hb: batch_to_device(shard_batch(mesh, hb),
                                                              mesh.device))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = deterministic
        if dist.is_initialized():
            dist.destroy_process_group()
    ref_params = {k: p.detach() for k, p in ref.model.named_parameters()}
    params = {k: p.detach() for k, p in state.model.named_parameters()}
    differ = [k for k, p in params.items() if not torch.equal(p, ref_params[k])]
    gap = max(float((p - ref_params[k]).abs().max()) for k, p in params.items())
    loss_differ = [k for k in ref_metrics if k != 'lr' and
                   not torch.equal(torch.as_tensor(metrics[k]), torch.as_tensor(ref_metrics[k]))]
    dp_it_s = 1.0 / statistics.median(dp_s[1:])
    ref_it_s = 1.0 / statistics.median(ref_s[1:])
    phase(f'4i (a) DP world 1 (NCCL, FileStore; init {init_s:.2f} s): {DP_STEPS} steps of '
          f'batch {DP_BATCH}, {dp_it_s:.2f} it/s against the Trainer step\'s {ref_it_s:.2f} '
          f'(median after step 1, deterministic algorithms) and 4d (a)\'s cli train '
          f'{RATES.get("train_it_s", float("nan")):.2f}; parameters '
          + (f'{len(differ)} of {len(ref_params)} differ (max {gap:.3e})' if differ else
             f'all {len(ref_params)} equal bit for bit')
          + f', losses ' + (f'{loss_differ} differ' if loss_differ else 'equal')
          + f'; total_loss {float(metrics["total_loss"]):.4f} [{card}]')
    if differ or loss_differ or state.step != DP_STEPS or ref.step != DP_STEPS:
        raise AssertionError(f'4i (a): the DP step differs from the Trainer step: {differ[:5]}, '
                             f'{loss_differ}')
    if not np.isfinite(float(metrics['total_loss'])):
        raise AssertionError('4i (a): non-finite loss')


def _h5_differ(a: dict, b: dict, by_design=('/metadata/uuid',)) -> list:
    """Datasets of two ``_datasets`` that differ, but for the parameters
    (the output dir, the config file, the device) and ``by_design``."""
    return sorted(k for k in set(a) | set(b)
                  if k not in by_design and not k.startswith('/metadata/extraction/parameters')
                  and (k not in a or k not in b or not _same(a[k][0], b[k][0])))


def check_parallel(card: str, seed: int, export: str, cfg_path: str, session_path: str,
                   model_dir: str, dat_run: dict, tmp: str) -> dict:
    """Phase 4i: (a) data parallel at world 1 (``check_dp_world1``); (b)
    ``extract --device-input prescaled`` on phase 4b's session, with one
    chunk held card against CPU (``reference_check``) and the bytes each
    frame sends to the card; (c) ``extract-batch``: printed commands over a
    ``.dat`` and an ``.avi`` session dir, then two sessions in process at
    once on the card, each of which must equal that session run alone; (d)
    the off-path ops card against CPU. Returns the kernels' launches of (b)
    and (c)."""
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch import cli, extract
    from moseq2_detectron_extract_tpu_torch.io.session import Session
    from moseq2_detectron_extract_tpu_torch.io.util import write_yaml
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, roi_align_kernel
    from moseq2_detectron_extract_tpu_torch.pipeline.steps import produce_chunks

    t_phase = time.perf_counter()
    os.makedirs(tmp, exist_ok=True)
    check_dp_world1(card, seed, export, cfg_path, tmp)

    # (b) the prescaled input through the CLI, and the bytes a frame uploads
    defaults = cli.extract_parser().parse_args([session_path])
    _, launches_b, wall_b, peak_b = _run_cli(
        session_path, model_dir, os.path.join(tmp, 'prescaled'), card, '4i (b) prescaled',
        SESSION_FRAMES, extra=('--device-input', 'prescaled'))
    expect = _expected_launches(SESSION_FRAMES, defaults.chunk_size, defaults.batch_size)
    if launches_b != expect:
        raise AssertionError(f'4i (b) launches {launches_b}, expected {expect}')
    session = Session(session_path)
    prepared = extract.prepare_session(session, {'chunk_size': defaults.chunk_size},
                                       device='cuda')
    chunk = next(produce_chunks(session, prepared))['chunk'][:FRAMES]
    predictor = Predictor.from_model_dir(model_dir, batch_size=BATCH)
    config = {'min_height': 0.0, 'max_height': 100.0, 'feature_window': 160,
              'expected_instances': 1, 'device_input': 'prescaled'}
    out = extract.process_chunk(chunk, predictor, config)
    per_frame = out['h2d_bytes'] / len(chunk)
    full_per_frame = chunk.shape[1] * chunk.shape[2] * chunk.dtype.itemsize
    box_err, score_err, _, n_same = reference_check(model_dir, chunk[:4], config)
    phase(f'4i (b) extract --device-input prescaled: {SESSION_FRAMES / wall_b:.1f} frames/s '
          f'(cli wall), full input (phase 4c (a), deterministic) '
          f'{SESSION_FRAMES / dat_run["wall"]:.1f}; bytes to the card per frame '
          f'{per_frame:.0f} (canvas {predictor.cfg.image_size}^2 + a 160^2 window) against '
          f'{full_per_frame} for the full input ({chunk.shape[1]}x{chunk.shape[2]}); '
          f'launches {launches_b}; peak {peak_b:.2f} GiB; reference check (4 frames, f32, card '
          f'vs CPU): boxes {box_err:.4f} px, scores {score_err:.2e}, cleaned windows equal at '
          f'{n_same} of 4 shared origins [{card}]')

    # (c) extract-batch: the printed commands, then two sessions at once
    root = os.path.join(tmp, 'batch')
    raw = np.fromfile(session_path, dtype='<u2').reshape(SESSION_FRAMES, 424, 512)
    sessions = {}
    for name, frames in (('forward', None), ('backward', raw[::-1])):
        for where in ('batch', 'alone'):
            d = os.path.join(tmp, where, name)
            os.makedirs(d)
            for extra_file in ('metadata.json', 'depth_ts.txt'):
                shutil.copy(os.path.join(os.path.dirname(session_path), extra_file), d)
            dat = os.path.join(d, 'depth.dat')
            if frames is None:
                os.symlink(session_path, dat)
            elif where == 'batch':
                np.ascontiguousarray(frames).tofile(dat)
            else:
                os.symlink(sessions[name]['batch'], dat)
            sessions.setdefault(name, {})[where] = dat
    del raw
    avi_dir = os.path.join(tmp, 'avi-tree', 'sess')
    os.makedirs(avi_dir)
    open(os.path.join(avi_dir, 'depth.avi'), 'wb').close()
    printed = {}
    for ext, where in (('.dat', root), ('.avi', os.path.dirname(avi_dir))):
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(['extract-batch', where, '--model', model_dir, '--extension', ext])
        printed[ext] = buf.getvalue().strip().splitlines()
        if rc != 0 or not all(line.startswith(f'python -m {PKG}.cli extract --model ')
                              for line in printed[ext]):
            raise AssertionError(f'4i (c) extract-batch {ext}: rc {rc}, {printed[ext]}')
    if sorted(line.split()[-1] for line in printed['.dat']) != \
            sorted(v['batch'] for v in sessions.values()) or \
            [line.split()[-1] for line in printed['.avi']] != \
            [os.path.join(avi_dir, 'depth.avi')]:
        raise AssertionError(f'4i (c) printed sessions: {printed}')
    cfg_file = os.path.join(tmp, 'batch-config.yaml')
    write_yaml(cfg_file, {'frame_trim': list(BATCH_TRIM), 'chunk_size':
                          SESSION_FRAMES - sum(BATCH_TRIM)})
    nframes = SESSION_FRAMES - sum(BATCH_TRIM)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        alone_s = {}
        for name, paths in sessions.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            rc = cli.main(['extract', paths['alone'], '--model', model_dir, '--config-file',
                           cfg_file])
            torch.cuda.synchronize()
            alone_s[name] = time.perf_counter() - t
            if rc != 0:
                raise AssertionError(f'4i (c) extract of {name} alone: rc {rc}')
        torch.cuda.synchronize()
        roi_align_kernel.launch_count = 0
        clean_kernel.launch_count = 0
        t = time.perf_counter()
        rc = cli.main(['extract-batch', root, '--model', model_dir, '--config-file', cfg_file,
                       '--in-process', '--max-concurrent', '2'])
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t
        launches_c = {'roi_align': roi_align_kernel.launch_count,
                      'clean': clean_kernel.launch_count}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if rc != 0:
        raise AssertionError(f'4i (c) extract-batch --in-process: rc {rc}')
    one = _expected_launches(nframes, nframes, defaults.batch_size)
    if launches_c != {k: 2 * v for k, v in one.items()}:
        raise AssertionError(f'4i (c) launches {launches_c}, expected twice {one}')
    differ = {}
    for name, paths in sessions.items():
        h5 = [os.path.join(os.path.dirname(paths[w]), 'proc', 'results_00.h5')
              for w in ('batch', 'alone')]
        together, solo = (_datasets(p) for p in h5)
        if together['/frames'][0].shape[0] != nframes:
            raise AssertionError(f'4i (c) {name}: {together["/frames"][0].shape[0]} frames')
        differ[name] = _h5_differ(together, solo)
    same_data = _same(_datasets(os.path.join(os.path.dirname(sessions['forward']['batch']),
                                             'proc', 'results_00.h5'))['/frames'][0],
                      _datasets(os.path.join(os.path.dirname(sessions['backward']['batch']),
                                             'proc', 'results_00.h5'))['/frames'][0])
    phase(f'4i (c) extract-batch printed {len(printed[".dat"])} .dat and '
          f'{len(printed[".avi"])} .avi commands; --in-process --max-concurrent 2, two '
          f'sessions of {nframes} frames on one card at once: {batch_s:.2f} s wall, alone '
          + ', '.join(f'{k} {v:.2f} s' for k, v in alone_s.items())
          + ' (cli wall, cudnn.deterministic); each session against itself alone: '
          + ', '.join(f'{k} ' + (f'{len(v)} differ: {v[:6]}' if v else 'all equal bit for bit')
                      for k, v in differ.items())
          + f' but the names and the uuid; the two sessions\' frames differ: {not same_data}; '
          f'launches {launches_c} [{card}]')
    if any(differ.values()) or same_data:
        raise AssertionError(f'4i (c): concurrent sessions differ from alone: {differ}')

    check_offpath(card, seed)
    phase(f'4i: {time.perf_counter() - t_phase:.1f} s [{card}]')
    return {'prescaled': launches_b, 'batch': launches_c}


def check_offpath(card: str, seed: int) -> None:
    """4i (d): ``largest_cc``, ``temporal_median`` and ``get_frame_features``
    (``use_cc=True``, ``mask_threshold=5``) on OFFPATH_FRAMES prepped frames
    of 424 x 512 on the card against the CPU: the component masks, the
    medians and the feature masks bit for bit; the moments (f32 sums in
    another order) to 1e-5 relative, and whether they are equal too."""
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch.ops.cc import largest_cc
    from moseq2_detectron_extract_tpu_torch.ops.morphology import temporal_median
    from moseq2_detectron_extract_tpu_torch.proc.features import get_frame_features
    from moseq2_detectron_extract_tpu_torch.synthetic import make_sentinel_chunk

    frames = torch.from_numpy(make_sentinel_chunk(OFFPATH_FRAMES, 424, 512, seed=seed + 11))
    gpu = frames.cuda()
    out, seconds = {}, {}
    for label, fn in (('largest_cc', lambda x: largest_cc(x > 20)),
                      ('temporal_median', lambda x: temporal_median(x, 5)),
                      ('get_frame_features', lambda x: get_frame_features(
                          x, frame_threshold=10, mask_threshold=5, use_cc=True))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        card_out = fn(gpu)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t
        out[label] = (card_out, fn(frames))
    equal = {}
    for label in ('largest_cc', 'temporal_median'):
        a, b = out[label]
        equal[label] = bool(torch.equal(a.cpu(), b))
    (feats_g, mask_g), (feats_c, mask_c) = out['get_frame_features']
    equal['feature_masks'] = bool(torch.equal(mask_g.cpu(), mask_c))
    gaps = {k: float(np.nanmax(np.abs(feats_g[k] - feats_c[k]) /
                               np.maximum(np.abs(feats_c[k]), 1.0)))
            for k in ('centroid', 'orientation', 'axis_length')}
    moments_equal = all(np.array_equal(feats_g[k], feats_c[k], equal_nan=True) for k in gaps)
    blob = int(out['largest_cc'][1].sum(dim=(1, 2)).min())
    phase(f'4i (d) off-path ops on {OFFPATH_FRAMES} frames of 424x512, card vs CPU: equal '
          f'{equal}; moments relative gap {gaps} (equal bit for bit: {moments_equal}); card '
          + ', '.join(f'{k} {v * 1e3:.1f} ms' for k, v in seconds.items())
          + f' (first call); smallest largest component {blob} px [{card}]')
    if not all(equal.values()) or max(gaps.values()) > 1e-5 or blob == 0:
        raise AssertionError(f'4i (d): card and CPU differ: {equal}, {gaps}')


OFFPATH_TOPK = ((16, 1), (1000, 100))  # phase 4j: (candidates, k) of topk_after_nms
P2_BOXES = 16                      # phase 4j: boxes of roi_align_level (fast160's post-NMS 16)


def _timed(fn):
    """(result, seconds) of one synchronised call on the card."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def check_ported_last(card: str, seed: int, predictor, frame) -> None:
    """Phase 4j: the functions ported last on CUDA tensors against the CPU on
    the same inputs (see the module's docstring for each tolerance)."""
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch import viz
    from moseq2_detectron_extract_tpu_torch.models import augment
    from moseq2_detectron_extract_tpu_torch.ops import find_invalid_pixels, nms, roi_align

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 40)
    raw = torch.from_numpy(rng.integers(0, 1000, (16, 424, 512)).astype(np.int16))
    raw[rng.random(raw.shape) < 0.01] = 0
    card_out, sec = _timed(lambda: find_invalid_pixels(raw.cuda()))
    equal = bool(torch.equal(card_out.cpu(), find_invalid_pixels(raw)))
    phase(f'4j find_invalid_pixels on {tuple(raw.shape)} raw frames: card equal to CPU {equal}, '
          f'{int(card_out.sum())} invalid; {sec:.4f} s [{card}]')
    if not equal:
        raise AssertionError('4j: find_invalid_pixels differs card vs CPU')

    for n, k in OFFPATH_TOPK:
        xy = rng.uniform(0, 400, (n, 2))
        boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(5, 80, (n, 2))], 1)
                                 .astype(np.float32))
        scores = torch.from_numpy(np.round(rng.uniform(0, 1, n), 2).astype(np.float32))
        keep = torch.from_numpy(rng.random(n) < 0.7)
        card_out, sec = _timed(lambda: nms.topk_after_nms(boxes.cuda(), scores.cuda(),
                                                          keep.cuda(), k))
        equal = all(torch.equal(a.cpu(), b) for a, b in
                    zip(card_out, nms.topk_after_nms(boxes, scores, keep, k)))
        phase(f'4j topk_after_nms on {n} candidates ({int(keep.sum())} kept), k {k}: card '
              f'equal to CPU {equal}; {sec:.4f} s [{card}]')
        if not equal:
            raise AssertionError(f'4j: topk_after_nms ({n}, {k}) differs card vs CPU')

    side = predictor.cfg.image_size // 4
    feat = torch.from_numpy(rng.normal(0, 1, (side, side, predictor.cfg.fpn_channels))
                            .astype(np.float32))
    xy = rng.uniform(0, 4 * side - 40, (P2_BOXES, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(8, 40, (P2_BOXES, 2))], 1)
                             .astype(np.float32))
    card_out, sec = _timed(lambda: roi_align.roi_align_level(feat.cuda(), boxes.cuda(), 7, 4))
    err = float((card_out.cpu() - roi_align.roi_align_level(feat, boxes, 7, 4)).abs().max())
    phase(f'4j roi_align_level on P2 {tuple(feat.shape)} f32, {P2_BOXES} boxes, out 7: card vs '
          f'CPU max abs err {err:.2e} (to 1e-5); {sec:.4f} s [{card}]')
    if not err <= 1e-5:
        raise AssertionError(f'4j: roi_align_level card vs CPU {err}')

    s = predictor.cfg.image_size
    image = torch.from_numpy(rng.uniform(0, 60, (s, s)).astype(np.float32))
    masks = torch.zeros((2, s, s), dtype=torch.bool)
    masks[0, s // 3:2 * s // 3, s // 4:3 * s // 4] = True
    kpts = torch.zeros((2, 8, 3))
    kpts[0, :, 0] = torch.linspace(s / 4 + 5, 3 * s / 4 - 5, 8)
    kpts[0, :, 1] = s / 2
    kpts[0, :, 2] = 2.0
    valid = torch.tensor([True, False])
    def to_cpu(d):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in d.items()}
    gen = torch.Generator(device='cuda').manual_seed(seed)
    draw = augment.take_draw(augment.draw_augment(gen, 1, s, 'cuda'), 0)
    cpu_draw = to_cpu(draw)
    card_out, sec = _timed(lambda: augment.augment_sample(
        draw, image.cuda(), masks.cuda(), kpts.cuda(), valid.cuda(), predictor.cfg))
    ref = augment.augment_sample(cpu_draw, image, masks, kpts, valid, predictor.cfg)
    img_err = (card_out['image'].cpu() - ref['image']).abs()
    beyond = int((img_err > 1e-4 * float(ref['image'].abs().max())).sum())
    same = {key: bool(torch.equal(card_out[key].cpu(), ref[key]))
            for key in ('masks', 'boxes', 'valid')}
    same['visibility'] = bool(torch.equal(card_out['keypoints'][..., 2].cpu(),
                                          ref['keypoints'][..., 2]))
    kp_err = float((card_out['keypoints'][..., :2].cpu() - ref['keypoints'][..., :2])
                   .abs().max())
    phase(f'4j augment_sample at {s}x{s} on one CUDA draw: image max abs err '
          f'{float(img_err.max()):.2e} ({beyond} pixels beyond 1e-4 of the largest value), '
          f'equal {same}, keypoints max abs err {kp_err:.2e}; {sec:.4f} s [{card}]')
    if beyond > 2 or not all(same.values()) or kp_err > 1e-4:
        raise AssertionError(f'4j: augment_sample card vs CPU: {beyond}, {same}, {kp_err}')

    pred = {k: v[0] for k, v in predictor(torch.from_numpy(frame[None])).items()}
    card_img, sec = _timed(lambda: viz.visualize_inference(frame, pred, 0.0, 100.0))
    host_img = viz.visualize_inference(
        frame, {k: v.cpu().numpy() for k, v in pred.items()}, 0.0, 100.0)
    plain = viz.visualize_inference(frame, {k: v[:0].cpu().numpy() for k, v in pred.items()},
                                    0.0, 100.0)
    equal = bool(np.array_equal(card_img, host_img))
    drawn = int((card_img != plain).any(axis=-1).sum())
    phase(f'4j visualize_inference (host drawing) on a {frame.shape} frame, '
          f'{int(pred["valid"].sum())} valid instance(s) of the card\'s prediction (score '
          f'{float(pred["scores"][0]):.2f}) handed over as CUDA tensors: {card_img.shape} image '
          f'equal to the drawing of the same prediction as numpy arrays {equal}, {drawn} pixels '
          f'drawn over the frame; {sec:.4f} s [{card}]')
    if not equal or drawn == 0:
        raise AssertionError(f'4j: visualize_inference equal {equal}, drawn {drawn}')
    phase(f'4j: {time.perf_counter() - t_phase:.1f} s [{card}]')


FAITHFUL_MODEL = 'bench_model'     # phase 4k: the faithful model's folder, beside --model-dir
FAITHFUL_STAGES = (('box', 7, 256), ('mask', 14, 1), ('keypoint', 7, 1))   # (stage, out, K)
FAITHFUL_CANVAS = 256


def check_faithful(card: str, seed: int, model_dir: str, chunk, config: dict,
                   session_path: str, export: str, tmp: str) -> dict:
    '''Phase 4k: the faithful model (``model_dir``, a 256 canvas, 256
    proposals an image from an NMS pool of 1,024) through the entry points a
    user calls: (a) ROIAlign at its three stages' shapes against the plain
    version; (b) ``Predictor.from_model_dir`` and phase 4's chunk through
    ``process_chunk`` (the kernels' launches, the proposal NMS's host syncs,
    the timed and the profiled chunks); (c) the reference check card against
    CPU; (d) ``extract`` through the CLI on phase 4b's session, timed, then
    again with cuDNN's deterministic algorithms, whose file must equal a
    serial ``extract_chunks`` run's; (e) SPLIT_STEPS train steps at
    its train shapes from its weights, measured only. Returns (b)'s and
    (d)'s launches and (a)'s numbers for the report line.'''
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch import extract
    from moseq2_detectron_extract_tpu_torch.cli import extract_parser
    from moseq2_detectron_extract_tpu_torch.io.annot import read_annotations
    from moseq2_detectron_extract_tpu_torch.io.session import Session
    from moseq2_detectron_extract_tpu_torch.models.checkpoint import load_model_dir
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, nms, roi_align_kernel
    from moseq2_detectron_extract_tpu_torch.proc.keypoints import default_keypoint_names

    t_phase = time.perf_counter()
    before = card_clocks()
    roi = check_roi_stages(np.random.default_rng(seed), REPS, card, FAITHFUL_STAGES,
                           FAITHFUL_CANVAS, '4k (a) roi_align')
    phase(f'4k (a) roi_align, the three stages of one batch of 16: device ms kernel '
          f'{roi["ms"]:.4f}, plain {roi["plain_ms"]:.4f}, bound {roi["bound_ms"]:.4f} by '
          f'{roi["bound_by"]} (the kernel at {100 * roi["bound_ms"] / roi["ms"]:.1f}% of it); '
          f'SM clock, memory clock, power, temperature before: {before}, after: '
          f'{card_clocks()} [{card}]')

    t = time.perf_counter()
    predictor = Predictor.from_model_dir(model_dir, batch_size=BATCH)
    cfg = predictor.cfg
    phase(f'4k (b) loaded {os.path.relpath(model_dir, REPO)} in {time.perf_counter() - t:.1f} s '
          f'(amp {cfg.amp_dtype}, canvas {cfg.image_size}, test sizes {cfg.min_size_test}-'
          f'{cfg.max_size_test}, {cfg.rpn_pre_nms_topk_test} proposals a level into an NMS pool '
          f'of {cfg.rpn_nms_global_cap}, {cfg.rpn_post_nms_topk_test} after it, batch {BATCH})')
    if (cfg.image_size, cfg.rpn_nms_global_cap, cfg.rpn_post_nms_topk_test) != (256, 1024, 256):
        raise AssertionError(f'{model_dir} is not the faithful model')
    tracker = extract.make_tracker()
    roi_align_kernel.launch_count = 0
    clean_kernel.launch_count = 0
    nms.sync_count, nms.launch_count = 0, 0
    out = extract.process_chunk(chunk, predictor, config, tracker=tracker)
    torch.cuda.synchronize()
    launches = {'roi_align': roi_align_kernel.launch_count, 'clean': clean_kernel.launch_count,
                'nms': nms.launch_count}
    found = check_chunk(out, launches)
    phase(f'4k (b) main path launches {launches}; NMS host syncs {nms.sync_count}; detections '
          f'found in {found} of {FRAMES} frames [{card}]')
    time_chunks(predictor, config, tracker, seed, card, '4k (b) ')

    box_err, score_err, kp_err, n_same = reference_check(model_dir, chunk[:4], config)
    phase(f'4k (c) reference check (4 frames, f32 model, card vs CPU plain versions): valid '
          f'and keep equal; boxes {box_err:.4f} px, scores {score_err:.2e}, keypoints '
          f'{kp_err:.4f} px; cleaned windows equal at {n_same} of 4 shared origins [{card}]')

    defaults = extract_parser().parse_args([session_path])
    out_dir = os.path.join(tmp, 'extract')
    _, cli_launches, wall, _ = _run_cli(session_path, model_dir, out_dir, card, '4k (d)',
                                        SESSION_FRAMES)
    expect = _expected_launches(SESSION_FRAMES, defaults.chunk_size, defaults.batch_size)
    if cli_launches != expect:
        raise AssertionError(f'4k (d) launches {cli_launches}, expected {expect}')
    h5_path = os.path.join(out_dir, 'results_00.h5')
    phase(f'4k (d): {SESSION_FRAMES} frames at {SESSION_FRAMES / wall:.1f} frames/s (cli wall, '
          f'find_roi, model load and the preview included); results_00.h5 '
          f'{os.path.getsize(h5_path) / 1e6:.2f} MB [{card}]')
    # cuDNN's default algorithms vary run to run (phase 4c (a): the keypoint
    # scores), so the file is held to the serial path with its deterministic
    # ones on both sides, bit for bit; the default run's file is compared too
    serial = Predictor.from_model_dir(model_dir, batch_size=defaults.batch_size,
                                      score_threshold=defaults.instance_threshold)
    session = Session(session_path)
    prepared = extract.prepare_session(session, {'chunk_size': defaults.chunk_size},
                                       device='cuda')
    out_d = os.path.join(tmp, 'extract-deterministic')
    try:
        torch.backends.cudnn.deterministic = True
        _run_cli(session_path, model_dir, out_d, card, '4k (d) deterministic', SESSION_FRAMES)
        results = serial_results(session, prepared, serial)
    finally:
        torch.backends.cudnn.deterministic = False
    differ = _compare_file(h5_path, results)
    differ_d = _compare_file(os.path.join(out_d, 'results_00.h5'), results)
    phase(f'4k (d): against a serial extract_chunks run at the CLI\'s batch size '
          f'({defaults.batch_size}), both with cudnn.deterministic: '
          + (f'{len(differ_d)} datasets differ: {differ_d}' if differ_d else
             f'all {len(results)} per-frame datasets equal bit for bit')
          + '; the run with cuDNN\'s default algorithms: '
          + (f'{len(differ)} differ: {differ}' if differ else 'all equal') + f' [{card}]')
    if differ_d:
        raise AssertionError('4k (d): the faithful extract differs from the serial path '
                             'with deterministic cuDNN at the same batch size')

    train_cfg, weights, _ = load_model_dir(model_dir)
    phase(f'4k (e) {SPLIT_STEPS} train steps from the faithful weights: canvas '
          f'{train_cfg.image_size}, train sizes {train_cfg.min_size_train}-'
          f'{train_cfg.max_size_train}, proposals {train_cfg.rpn_pre_nms_topk_train} a level, '
          f'{train_cfg.rpn_post_nms_topk_train} after an NMS with no cap, batch '
          f'{train_cfg.ims_per_batch}, on phase 4d\'s views [{card}]')
    train_step_split(train_cfg, read_annotations(export, default_keypoint_names), card, seed,
                     weights=weights, label='4k (e)')
    phase(f'4k: {time.perf_counter() - t_phase:.1f} s [{card}]')
    return {'launches': launches, 'extract_launches': cli_launches, 'roi': roi}


def start_build():
    '''Start the kernels' build (``native.build_library``: nvcc, no torch)
    in a thread, so that it runs while torch imports; the thread and a dict
    that gets the library's path and the build's seconds, or the error.'''
    import threading
    build = {}

    def run():
        try:
            from moseq2_detectron_extract_tpu_torch import native
            t = time.perf_counter()
            build['path'] = native.build_library()
            build['seconds'] = time.perf_counter() - t
        except Exception as exc:   # raised in the main thread, at phase 2
            build['error'] = exc

    thread = threading.Thread(target=run, name='kernel-build')
    thread.start()
    return thread, build


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--model-dir', default=os.path.join(REPO, 'benchmarks',
                                                            'bench_model_fast160'))
    args = parser.parse_args()

    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f'chip_smoke: the {PKG} package is not beside this script', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    build_thread, build = start_build()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        build_thread.join()
        print('chip_smoke: torch.cuda.is_available() is False; nothing run',
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase(f'torch {torch.__version__} (CUDA {torch.version.cuda}); set '
          f'torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, '
          f'torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}')

    phase('1/5 card')
    card = card_query()
    print(card, flush=True)
    tool_versions()

    phase('2/5 build kernels (nvcc -> ctypes; started with the script, beside the torch import)')
    from moseq2_detectron_extract_tpu_torch import native
    build_thread.join()
    if 'error' in build:
        raise build['error']
    lib_path, build_s = build['path'], build['seconds']
    native.load_library()
    with open(os.path.join(os.path.dirname(lib_path), 'build.log'), encoding='utf-8') as fh:
        for line in fh:
            if 'Used' in line or 'spill' in line:
                print('  ' + line.strip(), flush=True)
    phase(f'built {os.path.relpath(lib_path, REPO)} in {build_s:.1f} s')

    phase('3/5 kernels vs plain versions at main-path shapes')
    rng = np.random.default_rng(args.seed)
    roi, clean = check_kernels(rng, REPS, card)

    phase('3b/5 stage-2 variants vs plain versions (the ROIAlign stage-2 experiment)')
    stage2_launches, stage2 = check_stage2(rng, REPS, card, args.seed)

    phase('3c/5 the NMS kernel vs the plain fixpoint at the main path\'s shapes')
    nms_rows = check_nms(REPS, card, args.seed)

    phase('4/5 main path: Predictor.from_model_dir + process_chunk')
    from moseq2_detectron_extract_tpu_torch.extract import make_tracker, process_chunk
    from moseq2_detectron_extract_tpu_torch.models.predictor import Predictor
    from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
    from moseq2_detectron_extract_tpu_torch.ops import clean_kernel, nms, roi_align_kernel
    from moseq2_detectron_extract_tpu_torch.synthetic import make_sentinel_chunk
    t = time.perf_counter()
    predictor = Predictor.from_model_dir(args.model_dir, batch_size=BATCH)
    phase(f'loaded {os.path.relpath(args.model_dir, REPO)} in '
          f'{time.perf_counter() - t:.1f} s (amp {predictor.cfg.amp_dtype}, canvas '
          f'{predictor.cfg.image_size}, batch {BATCH})')
    config = {'min_height': 0.0, 'max_height': 100.0, 'feature_window': 160,
              'expected_instances': 1}
    chunk = make_sentinel_chunk(FRAMES, 424, 512, seed=args.seed)
    tracker = make_tracker()

    level_formats = []
    pool_levels = MaskKeypointRCNN.pool_levels

    def spy(fpn_feats):
        level_formats.append([(str(f.dtype), f.is_contiguous(memory_format=torch.channels_last))
                              for f in fpn_feats[:4]])
        return pool_levels(fpn_feats)

    MaskKeypointRCNN.pool_levels = staticmethod(spy)
    roi_align_kernel.launch_count = 0
    clean_kernel.launch_count = 0
    nms.launch_count = 0
    try:
        out = process_chunk(chunk, predictor, config, tracker=tracker)
        torch.cuda.synchronize()
    finally:
        MaskKeypointRCNN.pool_levels = staticmethod(pool_levels)
    nhwc = all(dt == 'torch.bfloat16' and cl for fmt in level_formats for dt, cl in fmt)
    phase(f'FPN levels reaching the pool (dtype, channels_last) per batch: {level_formats[0]} '
          f'... ({len(level_formats)} batches): '
          + ('NHWC bf16 already, the NHWC view copies nothing' if nhwc else
             'not NHWC bf16: pool_levels copies each level once per batch'))
    launches = {'roi_align': roi_align_kernel.launch_count,
                'clean': clean_kernel.launch_count, 'nms': nms.launch_count}
    phase(f'main path launches: {launches}')

    found = check_chunk(out, launches)
    phase(f'detections found: {found} of {FRAMES} frames [{card}]')
    time_chunks(predictor, config, tracker, args.seed, card)

    box_err, score_err, kp_err, n_same = reference_check(args.model_dir, chunk[:4], config)
    phase(f'reference check (4 frames, f32 model, card vs CPU plain versions): boxes '
          f'{box_err:.4f} px, scores {score_err:.2e}, keypoints {kp_err:.4f} px, cleaned '
          f'windows equal at {n_same} of 4 shared origins')

    work = tempfile.mkdtemp(prefix='m2de-smoke-')
    try:
        phase('4b/5 session path: write_raw_session + prepare_session + extract_chunks')
        session_launches, extract_launches, session_path, prepared, results_h5, dat_run = \
            check_session(predictor, card, args.seed, args.model_dir,
                          os.path.join(work, 'session'))

        phase('4d/5 training: the train command at full width, the step split, card vs CPU, '
              'the export')
        train_launches, export, cfg_path, trained = check_training(
            card, args.seed, args.model_dir, os.path.join(work, 'train'))

        phase('4e/5 the model lifecycle: convert-weights, train --init-weights, evaluate, '
              'compile-model, infer-dataset, find-roi')
        lifecycle_launches = check_lifecycle(card, args.seed, export, cfg_path, trained,
                                             session_path, prepared,
                                             os.path.join(work, 'lifecycle'))

        phase('4f/5 the preview commands: visualize-raw, visualize-result, the reverse '
              'crop-rotate card vs CPU')
        check_preview_commands(card, session_path, results_h5, os.path.join(work, 'preview'))

        phase('4g/5 the result upkeep: find-outliers, trim-result, manual-flip, verify-flips, '
              'generate-extract-config, dataset-info, system-info, extract --report-outliers')
        check_result_upkeep(card, os.path.join(os.path.dirname(results_h5), LONG_RESULTS),
                            session_path, export, args.model_dir,
                            os.path.join(work, 'upkeep'))

        phase('4h/5 compressed depth and dataset generation: convert-raw-to-avi, extract on '
              'depth.avi, generate-dataset')
        avi_launches = check_compressed(card, session_path, dat_run, args.model_dir,
                                        os.path.join(work, 'compressed'))

        phase('4i/5 the last slice: data parallel at world 1, extract --device-input '
              'prescaled, extract-batch (two sessions at once), the off-path ops')
        last_launches = check_parallel(card, args.seed, export, cfg_path, session_path,
                                       args.model_dir, dat_run, os.path.join(work, 'parallel'))

        phase('4j/5 the functions ported last: find_invalid_pixels, topk_after_nms, '
              'roi_align_level, augment_sample card vs CPU; visualize_inference of a card '
              'prediction (host drawing)')
        check_ported_last(card, args.seed, predictor,
                          chunk[int(np.argmax(out['num_instances'] > 0))])

        phase('4k/5 the faithful model (benchmarks/bench_model: canvas 256, 256 proposals from '
              'an NMS pool of 1,024): ROIAlign at its shapes, process_chunk, card vs CPU, '
              'extract, train steps')
        faithful = check_faithful(
            card, args.seed,
            os.path.join(os.path.dirname(os.path.abspath(args.model_dir)), FAITHFUL_MODEL),
            chunk, config, session_path, export, os.path.join(work, 'faithful'))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    phase(f'5/5 report (the whole smoke: {time.perf_counter() - T0:.1f} s wall) [{card}]')
    kernels = [
        {'name': 'roi_align', 'route': 'cuda', 'source': f'{PKG}/csrc/roi_align.cu',
         'replaces': 'moseq2_detectron_extract_tpu/ops/pallas_roi_align.py:35',
         'launches': launches['roi_align'], 'session_launches': session_launches['roi_align'],
         'extract_launches': extract_launches['roi_align'],
         'train_export_launches': train_launches['roi_align'],
         'lifecycle_launches': lifecycle_launches,
         'avi_extract_launches': avi_launches['roi_align'],
         'prescaled_extract_launches': last_launches['prescaled']['roi_align'],
         'batch_extract_launches': last_launches['batch']['roi_align'],
         'max_abs_err': roi['max_abs_err'], 'max_ulps': roi['max_ulps'],
         'one_ulp': roi['one_ulp'],
         'ms': roi['ms'], 'op_ms': roi['op_ms'], 'plain_ms': roi['plain_ms'],
         'bound_ms': roi['bound_ms'], 'bound_by': roi['bound_by'], 'library_ms': None,
         'faithful': {'launches': faithful['launches']['roi_align'],
                      'extract_launches': faithful['extract_launches']['roi_align'],
                      'max_abs_err': faithful['roi']['max_abs_err'],
                      'ms': faithful['roi']['ms'], 'plain_ms': faithful['roi']['plain_ms'],
                      'bound_ms': faithful['roi']['bound_ms'],
                      'bound_by': faithful['roi']['bound_by'],
                      'stages': faithful['roi']['stages']}},
        {'name': 'clean', 'route': 'cuda', 'source': f'{PKG}/csrc/clean.cu',
         'replaces': 'moseq2_detectron_extract_tpu/ops/pallas_clean.py:74',
         'launches': launches['clean'], 'session_launches': session_launches['clean'],
         'extract_launches': extract_launches['clean'],
         'avi_extract_launches': avi_launches['clean'],
         'prescaled_extract_launches': last_launches['prescaled']['clean'],
         'batch_extract_launches': last_launches['batch']['clean'],
         'max_abs_err': clean['max_abs_err'],
         'ms': clean['ms'], 'plain_ms': clean['plain_ms'], 'bound_ms': clean['bound_ms'],
         'bound_by': clean['bound_by'], 'library_ms': None,
         'faithful': {'launches': faithful['launches']['clean'],
                      'extract_launches': faithful['extract_launches']['clean']}},
    ]
    kernels.append({'name': 'nms', 'route': 'cuda', 'source': f'{PKG}/csrc/nms.cu',
                    'replaces': None, 'launches': launches['nms'], 'max_abs_err': 0,
                    'library_ms': None, 'shapes': nms_rows})
    replaces = {'retile': 59, 'transpose': 92, 'dotswap': 114, 'noxpose': 133}
    for variant, line in replaces.items():
        row = stage2[variant]
        kernels.append({'name': f'roi_stage2_{variant}', 'route': 'cuda',
                        'source': f'{PKG}/csrc/roi_stage2_resident.cu',
                        'replaces': f'benchmarks/roi_stage2_exp.py:{line}',
                        'launches': stage2_launches[variant],
                        'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
                        'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
                        'bound_by': row['bound_by'], 'library_ms': None,
                        'experiment_ms': row['experiment_ms'],
                        'experiment_bound_ms': row['experiment_bound_ms']})
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
