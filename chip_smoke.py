#!/usr/bin/env python3
"""On-card smoke run of motcpp_tpu_torch: builds the CUDA kernels from
the sources in this checkout, holds each against its plain PyTorch
version, drives the ByteTrack, SORT, OC-SORT, DeepOC-SORT, BoostTrack,
HybridSORT and UCMCTrack multi-stream paths at the bench's shapes, the
live-ReID BoT-SORT, StrongSORT, DeepOC-SORT, BoostTrack and HybridSORT
paths at the bench's live-ReID shape, StrongSORT with live camera
motion from frames, the serving runtime (TrackingService over the
native stream mux) at the ByteTrack flagship and at live ReID, the
utilities (configs read without PyYAML, the eval CLI's goldens and the
MOT metrics, checkpoint failover, profiling, the ReID warm-up, the native
IO), the streams sharded over devices (the runner, the service, the
emission collectives and a two-process dryrun), int8 and dense-lite
ReID (live BoT-SORT through the int8 embed and the auction kernel),
the serving tail-latency harness and the SLO sweep, and the
time-attribution tools (the per-piece OSNet profile, the stage
microbenchmarks, the stage ablation and the select microbench), the
long-horizon streaming tool, oriented-box SORT and the live sparse-flow
leg, the ablation accuracy scoreboard with its cadence and
priority-budget probes, and the accuracy and evaluation tools (the
synthetic benchmark, run_benchmark.sh, the golden regenerators and the
demo-GIF tool's tracking), and the examples (motcpp_tpu_torch/examples/),
and the scoreboard (motcpp_tpu_torch/bench.py), and checks what they
emit. The trackers are
built at the scoreboard's configurations by
``motcpp_tpu_torch/scripts/tracker_fns.py``.

    python3 chip_smoke.py [--baseline OTHER_AUCTION_CU]

``--baseline`` names another source of the auction kernel with the same
C interface (such as the parent commit's ``csrc/auction.cu``, unpacked
from git into a gitignored directory); phases 2 and 3 then time it
beside this checkout's kernel on the same inputs. Without it they print
the previous kernel's times on these inputs as PERF.md records them.

Needs one CUDA device (written for an H100, sm_90a) and nvcc. The main
paths run and are timed with PyTorch's defaults (cuDNN may use TF32 for
float32 convolutions, matrix products do not); TF32 is off only around
the float32 checks of phases 6, 8 and 20 (e) and the plain versions'
timings, so those compare float32 arithmetic. Phases:

  1. build the auction kernel (and, in parallel, the OSBlock kernel, the
     native mux and the native IO library); print its registers and
     spills and the card's name and power limit;
  2. the auction kernel against the plain auction at (K, N) = (64, 32),
     (128, 64), (128, 128), (256, 128), BoT-SORT's (64, 16), and
     detections by tracks at the ablation scoreboard's (96, 192) and the
     eval CLI's capacities (128, 256), and on
     the edge classes of tests/auction_cases.py (ties, zero benefits of
     either sign, empty problems, K or N of 1, N of 16, 33 and 128, K of
     256, a problem that hits MAX_ROUNDS): identical row2col/col2row;
  3. the ByteTrack main path: MultiStreamRunner over ByteTrack with the
     kernel (lap_impl="auction_pallas"), S=4096 streams, K=64 slots,
     N=32 dets, 16 objects, T=60 frames; one warm-up and 3 timed
     run()s, each launching the kernel exactly 2*T times; then the
     kernel timed on the inputs the main path gave it (stage 1 and
     stages 2+3), beside its plain version and its bound, and a
     torch.profiler trace of 10 frames;
  4. the same rollout on 256 streams through the kernel and through the
     plain auction: identical masks, ids and boxes;
  5. the OSBlock kernel's build time, its registers and spills, and the
     tensor-core (HMMA) instructions of each instantiation in the built
     library (cuobjdump -sass): some in bfloat16, none in float32;
  6. the OSBlock kernel against its plain version at the six osnet_x1_0
     block shapes (64 crops of 256x128, seeded inputs and weights):
     float32 max |kernel - plain| / max |plain| <= 1e-4; bfloat16
     per-crop cosine >= 0.999 against the plain version in bfloat16 and
     >= 0.995 against float32;
  7. the live-ReID main path: MultiStreamRunner over BoT-SORT
     (with_reid, emb_dim=512, the auction kernel) with
     make_embed_fn(osnet_x1_0, bfloat16, fused=True) as embed_fn, S=128
     streams, N=16 crops of 256x128 uint8 made on the card, K=64, 14
     objects, T=4; every frame, then BoT-SORT's deployed cadence 8; one
     warm-up and 3 timed run()s each, with the kernels' launch counts
     checked; then the OSBlock kernel on the inputs the main path gave
     each block, and a torch.profiler trace of one frame;
  8. kernel path against plain path: fused and plain folded embeddings
     of the same crops in float32 (per-crop cosine >= 0.9999); BoT-SORT
     with the auction kernel and with the plain auction on the same
     embeddings (identical masks, ids, boxes); and, reported, the share
     of identical emissions of the live path with kernel and with plain
     embeddings;
  9. SORT at bench.py's saturation point (min_hits=1, max_age=3), S=4096,
     K=64, N=32, 16 objects, T=60, one kernel launch a frame: timed as
     phase 3, the kernel on the path's own inputs beside its bound, a
     profile, and the kernel path against the plain path on 256 streams;
 10. the same for OC-SORT (min_hits=1) at S=2048, bench.py's default,
     two launches a frame (stage 1 and the OCR rematch);
 11. StrongSORT live ReID (n_init=1, gallery_cap=16, osnet_x1_0 bf16
     fused, 256x128 crops made on the card, the scene of phase 7) at its
     deployed point (bench.py DEPLOYED --emb-priority 0.6: N=16, a budget
     of round(0.6*128*16) = 1229 crops filled by embedding priority, of
     about 1700 valid crops) and every frame (2048 crops), six OSBlock and
     two auction launches a frame; at the deployed point both kernels on
     the path's own inputs beside their plain versions and bounds, a
     profile of one frame, the auction kernel path against the plain
     auction on the same embeddings, and the share of identical emissions
     with kernel and plain embeddings;
 12. DeepOC-SORT: motion-only as phase 10 at bench.py's config
     (min_hits=1, embedding_off, cmc_off), two launches a frame (stage 1
     and the OCR rematch); live ReID as phase 11 at its deployed cadence
     8 (embedding_off=False, cmc_off, 256 crops a frame);
 13. BoostTrack: motion-only (min_hits=1), one launch a frame; live ReID
     with with_reid at its deployed cadence 2 (1024 crops a frame);
 14. HybridSORT: motion-only (min_hits=1, with_reid=False), three
     launches a frame (stage 1, BYTE, the rematch); live ReID with
     with_reid at its deployed priority 0.8 (a budget of 1638 crops);
 15. UCMCTrack at bench.py's config (the defaults, no calibration),
     S=2048, as phase 10: two launches a frame (stage 1, then stages 2
     and 3 as one launch);
 16. live camera motion, bench.py's strongsort_cmc_ecc row: StrongSORT
     (n_init=1, gallery_cap=16) under MultiStreamRunner with
     cmc_fn=ecc_jax_batch at CMC scale 0.15, S=512, T=60, over
     (60, 512, 162, 288) float32 panning textures made on the card:
     the warps of one frame pair against the known pans (x = -pan within
     1e-3 px, ok everywhere), the ECC's device time on one pair, ms per
     frame-batch and streams at 30 FPS (two auction launches a frame),
     the auction kernel on the path's inputs beside its bound, a profile
     of one frame split among the ECC, the tracker and the auction
     kernel, the live rollout split across two run() calls against a
     rollout fed the same estimator's warps (identical masks, boxes
     within 1e-4), and a run without camera motion, which must differ;
 17. the serving runtime: TrackingService (from_tracker) over the native
     mux, which must have built and loaded (no Python fallback), every
     tick's frames submitted untimed, one warm-up tick, each timed tick
     split into the mux's assemble, the dispatch (copies to the card and
     launches) and the fetch (the wait for the card and the copy back),
     stats() and the runner's ms per frame-batch of the same path beside
     it: the ByteTrack flagship (S=4096, phase 3's frames, T ticks, two
     auction launches a tick) and BoT-SORT live ReID at cadence 8
     (phase 7's shape and crops, 256x128 uint8 crops through the mux,
     only the scheduled slots' crops sent to the card, 16 ticks so every
     slot embeds twice, six OSBlock and two auction launches a tick),
     each emitting the runner's masks and ids on the same frames, boxes
     within 1e-4; then on 8 streams a gappy schedule emits, frame for
     frame, the dense one's rows bit for bit, and two step_async ticks
     in flight equal two step() calls; FrameTimer times the same ticks;
 18. the utilities: (a) whether PyYAML imports here, the nine configs
     through the port's reader, and scripts/tune.py::evaluate_params
     for ByteTrack (max_dets=max_tracks=128, the auction kernel) over
     MOT17-mini's first 8 frames for the YAML defaults and 3 seeded
     draws, scored by the port's metrics: rows and HOTA, MOTA, IDF1
     equal to the same loop on the CPU (the plain auction); (b)
     scripts/regen_golden.py (the eval CLI) writes the tests/golden_long
     sets (--no-ablation --limit-frames 150, max_dets=max_tracks=128) of
     SORT, ByteTrack, OC-SORT, StrongSORT and BoT-SORT, a spawned
     process a set (tests/test_torch_cuda.py runs the other four through
     the CLI on the card) through the native writer, byte for byte, and their
     scores (scripts/update_accuracy_table.py) equal
     tests/accuracy_mot17mini.json, with the wall time; (c) checkpoint failover through TrackingService in
     both formats (.npz and a torch file): the ByteTrack flagship (S=4096,
     phase 3's frames, 20 ticks cut after 10) and BoT-SORT live ReID at
     cadence 8 (phase 7's shape and crops, 16 ticks cut after 8, a
     multiple of the cadence: the tick is not in the state), each
     continuation equal to the uninterrupted run bit for bit, with each
     file's size and its save and load times; (d) one flagship tick and
     one live tick under utils/profiling.py::trace, whose exported traces
     must name the auction kernel (and the live one the OSBlock kernel),
     and FrameTimer's p50 of phase 17's ticks beside phase 17's median;
     (e) ReIDBackend.warmup() on the card runs the unfolded forward (no
     kernel launch, as the JAX backend's Flax module) and embeds its
     batch as the CPU does within 1e-3; (f) the native parser equals the
     Python parser on both MOT17-mini det.txt files;
 19. streams sharded over devices, two shards on the one card
     (``devices=["cuda", "cuda"]``): (a) the ByteTrack flagship (phase
     3's frames) through the sharded runner emits phase 3's masks, ids
     and boxes bit for bit, 4 auction launches a frame, ms per
     frame-batch beside phase 3's, and the kernel against its plain
     version on each shard's own stage-1 and stage 2+3 inputs (2048
     problems a stage-1 launch); (b) emission_stats and
     per_stream_emissions over (a)'s masks as shards equal plain
     reductions of phase 3's masks; (c) live BoT-SORT at cadence 8
     (phase 7's shape and crops, 64 streams a shard) through the runner
     (phase 7's emissions bit for bit) and through TrackingService with
     compacted crops (phase 17's service's emissions bit for bit), 6
     OSBlock and 2 auction launches a shard a frame; (d) live HybridSORT
     at priority budget S*N equals one device, and at its deployed 0.8
     (1638 crops) each shard embeds exactly 819 crops a frame, timed
     beside phase 14; (e) the flagship service (20 ticks cut after 10)
     fails over sharded -> .npz -> one device and one device -> torch
     file -> sharded, each continuation equal to the uninterrupted run
     bit for bit; (f) motcpp_tpu_torch.parallel.multihost's two-process
     dryrun over gloo, each process's four shards on the card;
 20. int8 and dense-lite ReID at phase 7's widths (osnet_x1_0, D=512,
     256x128 crops, S=128, N=16): (a) quantize_osnet on the host, timed,
     and the int8 and float weight bytes make_embed_fn_int8 puts on the
     card; (b) the int8 embed of 256 and 2048 crops through torch._int_mm
     against the plain int8 product (float64 sums) bit for bit, its device
     ms beside the bf16 fused and folded embeds, a profile of one 256-crop
     embed split among the int8 products, quantize, dequantize and the
     depthwise convs, and the per-crop cosine to the bf16 fused
     embeddings; (c) live BoT-SORT at cadence 8 with make_embed_fn_int8
     through MultiStreamRunner beside phase 7's bf16 row (no OSBlock
     launch; the auction kernel against its plain version on the path's
     own inputs; the share of emissions equal to phase 7's); (d) the same
     through TrackingService on phase 17's frames, equal to the runner bit
     for bit; (e) compose_lite_dense + _forward_folded_dense against
     forward_folded_f32 on the card with TF32 off (relative error
     <= 1e-4), each forward's ms;
 21. the serving tail-latency harness and the SLO sweep
     (motcpp_tpu_torch/scripts/serving_latency.py and slo_sweep.py, in
     process; SLO_TICKS timed ticks a run): (a) the harness at its
     defaults (ByteTrack, S=1024, N=32, K=64, 14 objects, 4 producer
     threads submitting through the native mux, 8 warm-up ticks),
     unpipelined and pipelined; (b) the flagship (S=4096, N=32, K=64,
     16 objects) in --device-data mode, its first RING_EQUAL_TICKS ticks
     equal bit for bit to the same dets through the native mux; (c) the
     SLO sweep: the null row, the five deployed live-ReID points down
     their ladders (osnet_x1_0 module forward in bf16, 256x128 crops
     made on the card, pipelined at depth 4) and the producer row. Each
     run's service is built on the native mux, every dispatched tick
     launches the auction kernel as often as its tracker's step does
     (STEP_LAUNCHES) and resolves with every live stream present, the
     kernel's inputs in each run's last warm-up tick give the plain
     auction's assignment exactly, no frame is dropped, the percentiles
     are finite and ordered, and no sweep row is an error. No latency is
     held to a bound: a p99 over 33 ms is a finding, not a failure.
 22. the time-attribution tools of motcpp_tpu_torch/scripts/, in process
     (PROFILE_*, STAGE_ITERS, ABLATE_*, SELECT_* set their sizes): (a)
     profile_osnet, osnet_x1_0 at 2048 crops of 256x128 in bf16, --fused
     --roofline: the module forward, the fused forward and each of their
     pieces alone (conv1, max pool, six OSBlocks, two transitions, conv5,
     head) beside its bound, the OSBlock kernel rows beside their plain
     version; the fused forward's per-crop cosine to the module forward
     in float32 (TF32 off), each piece alone in bf16 (on the float32
     chain's input, both paths to float32 and to each other) and each
     kernel block to its plain version at least 0.999 (the bf16
     forwards' cosines to each other and to float32, which rounding
     grown through depth sets, are printed), and the six kernel block
     rows within 20% of phase 7's six-block kernel time; (b)
     profile_stages at S=4096, every stage (plain auction, the auction
     kernel, IoU, Kalman predict and update, sof_jax_batch): the
     kernel's row2col and col2row equal the plain auction's; (c)
     ablate_cost on ByteTrack and BoostTrack at S=2048, T=30, the LAP and
     the IoU stubbed: each stub called, and one unstubbed rollout split
     by device time with kernels inside the LAP's ranges; (d)
     microbench_select at S=2048: every case exact. The tools' warm-up
     calls and comparison launches are not counted;
 23. long-horizon streaming (motcpp_tpu_torch/scripts/longrun_stability.py,
     in process, its scene made on the card chunk by chunk): (a) its
     defaults but LONG_FRAMES frames, ByteTrack at S=256, K=64, N=32 in
     chunks of 500, every emitted row finite, ms per frame-batch of
     each chunk, the largest emitted id and next_id; (b) OC-SORT over
     LONG_OC_FRAMES frames (its observation ring wraps); (c) (a)'s
     first LONG_EQUAL_CHUNKS chunks again as one run(): masks, ids,
     boxes and the carried state equal bit for bit; (d) the kernel on
     the solves of (a)'s last frame held to the plain auction (max abs
     err 0) beside its bound; (e) two launches a frame in (a) and (b);
     and a profile of 10 frames of each path (kernels a frame, busy
     share);
 24. oriented-box SORT (is_obb, min_hits=1, max_age=3) at S=2048, K=64,
     N=32, OBB_T frames (data/synthetic.py::obb_stream_dets): one
     warm-up and 3 timed runs, the peak device memory, the kernel on the path's
     inputs beside its bound, a profile of 10 frames (kernels a frame,
     busy share, iou_batch_obb's share of the device time), the kernel
     path against the plain path on 256 streams (identical) and the card
     against the CPU on 8 streams (masks and ids identical, boxes within
     1e-3 px); then bench.py's --cmc sof leg: StrongSORT (n_init=1,
     gallery_cap=16) under cmc_fn=sof_jax_batch at CMC scale 0.15,
     S=512, SOF_T frames of 162x288 panning textures made on the card:
     the warps of one pair against the known pans (within 0.05 px, ok
     everywhere), sof_jax_batch's device time on one pair, one warm-up
     and 3 timed runs, a profile of 3 frames, two run() calls against
     one (identical), the card
     against the CPU on 8 streams (masks and ids identical, boxes within
     1e-2 px) and a run without camera motion, which must differ;
 25. the ablation accuracy scoreboard
     (motcpp_tpu_torch/scripts/ablation_benchmark.py, in process, on the
     card through the auction kernel, SCORE_FRAMES frames of the
     calibrated ablation scene, max_tracks=192, max_dets=96, one stream):
     (a) all eleven SCOREBOARD rows, each row of
     tests/accuracy_ablation.json within 1.0 HOTA of it, and the JAX
     package's orderings and scale bars (MT >= 40, ML <= 10, HOTA >= 60 on
     every row; StrongSORT and UCMCTrack MT >= 50); (b) bench.py's five
     DEPLOYED points (cadence 8, 8 and 2; priority 0.6 and 0.8), each
     within 1.0 HOTA of its committed row, its cost against (a)'s row
     printed, every frame's priority selection equal to the host's; (c)
     ByteTrack and BoostTrack on the host through the plain auction, the
     card's rows within 0.5 of them on HOTA, MOTA, IDF1, DetA and AssA;
     (d) BoostTrack again on the card, its metrics and rows identical;
     (b) with (d), and (c), run in two worker processes beside (a); (e)
     the kernel on the solves of StrongSORT's and BoostTrack's middle
     frames (tracks by detections, (1, 192, 96), and detections by
     tracks, (1, 96, 192), eight columns a lane) against the plain
     auction (max abs err 0), beside its bound. (d) is a comparison:
     its launches are not counted;
 26. the accuracy and evaluation tools of motcpp_tpu_torch/scripts/, in
     process: (a) synthetic_benchmark.py at its defaults (nine trackers,
     300 frames, 24 objects, max_tracks=64, max_dets=48, one stream)
     through the auction kernel, one task a row in a pool of five
     spawned processes, every row launching it, its table, each row's
     seconds and launches; ByteTrack and BoostTrack also on the host
     through the plain auction in the same pool, the card's rows within
     0.5 on HOTA, MOTA, IDF1, DetA and AssA; (b) the kernel on
     ByteTrack's frame-150 solves against the plain auction (max abs err
     0), beside its bound; (c) the tune loop is phase 18 (a). While the
     pool runs (a), this process runs (d)-(f): (d) run_benchmark.sh (TRACKERS=bytetrack, CLI_FLAGS="--lap
     auction_pallas") over MOT17-mini in a subprocess: result files equal
     to the host CLI's (--cpu --lap auction_pallas) byte for byte, its
     eval table equal to eval_mot's on them; (e) regen_golden.py's nine
     tests/golden sets (exact JV) and regen_golden_cmc.py's
     botsort_sofjax rows byte for byte, regen_golden_reid.py's forward
     fingerprint (TF32 off) within one 1e-4 rounding step and, where cv2
     or PIL reads the jpgs, its tracker rows (frames and ids exact,
     values within 0.05); (f)
     generate_demo_gifs.py's tracking of the 40-frame pan scene: ids
     equal to the CPU's, boxes within 1e-4. Only (a)'s launches are
     counted ((b) is a comparison, (d)'s are another process's);
 27. the examples of motcpp_tpu_torch/examples/ (the JAX package's
     examples/), in process through main(), at tests/test_examples.py's
     sizes: (a) each example that steps a tracker on the card with --lap
     auction_pallas, its auction launches counted from 0 and equal to
     the count its code gives (EXAMPLE_STEPS); (b) the same example with
     --cpu (the plain auction): the same lines (ids, counts and
     emissions exactly; update()'s boxes within 1e-3 px, the estimated
     pans within 0.05 px); (c) each example at its default --lap on the
     card and on the CPU: the same lines (but multistream_serving's
     times; async_serving's counts follow its threads' timing, so only
     its markers, and that rows were served); (d) the kernel on the
     solves of one multistream_serving frame against the plain auction
     (max abs err 0), beside its bound. Only (a)'s launches are counted.
 28. the scoreboard (motcpp_tpu_torch/bench.py, the JAX package's
     bench.py; its timing carries the tracker state from the warm-up
     through BENCH_REPEATS timed runs): (a) ``python -m
     motcpp_tpu_torch.bench --quick --repeats 1`` in a fresh process,
     beside (b)-(d) in this one: exit 0, nine rows with ByteTrack last,
     each row's auction launches as its tracker's step gives them, and no
     root BENCH_*.json written or added; (b) the six capacity rows
     (K=128, N=64 and 128, S=1024) in process through the single-tracker
     flags, their launches counted, and the kernel on the solves of one
     frame of the K=128, N=128 ByteTrack row against the plain auction,
     beside its bound; (c) the BoT-SORT live leg at cadence 8 with
     --fused (6 OSBlock and 2 auction launches a frame): its emissions
     equal to the same leg's with every block through osblock_reference,
     and the OSBlock kernel on one frame's blocks against its plain
     version; (d) ByteTrack's row at 256 streams through the kernel and
     through --lap auction: identical masks, ids and boxes. The launches
     of (a)-(c)'s rows are counted, (a)'s from its rows' ``#`` lines.

Any failed check exits nonzero before the result is printed. The last
line is ``{"ok": true, "device": {...}}``; the line before it is the
card's name and power limit, and the one before that lists the kernels
with their times and bounds (those of phases 3 and 7) and their
launches summed over the main paths of phases 3, 7 and 9-28, each
counted from zero; before those, the script's wall time.
"""

from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

# the run and its result line describe one card: unless the caller chose
# the visible devices, use the first
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the H100's published rates (HBM, float32 and bf16), the timing and the
# bounds are shared with the measurement tools in motcpp_tpu_torch/scripts
from motcpp_tpu_torch.utils.profiling import (  # noqa: E402
    HBM_BYTES_PER_S,
    auction_bound_ms,
    call_ms,
    crop_cosine,
    device_split,
    exact_float32,
    full_tile_bound_ms,
    osblock_bound_ms,
    ranged,
    same_bits,
)
# the timing protocol and the live-ReID crops are shared with the
# scoreboard (motcpp_tpu_torch/bench.py); a failed check of either raises
# the same exception
from motcpp_tpu_torch.utils.benchrun import (  # noqa: E402
    CheckFailure,
    rolled_crops,
    timed_runs,
)

# REPEATS timed runs a path (5 until the script outgrew 900 s)
S, K, N, N_OBJ, T, REPEATS = 4096, 64, 32, 16, 60, 3
CHECK_SHAPES = [(64, 32, 4096), (128, 64, 1024), (128, 128, 1024),
                (256, 128, 256), (64, 16, 256), (96, 192, 256),
                (128, 256, 64)]
# ms of the previous auction kernel (one CTA of 256 threads per problem,
# a K-long column scan per round) on the inputs of phases 2 and 3, as
# PERF.md records them from its run J (NVIDIA H100 80GB HBM3, 700 W);
# printed when no --baseline is given
PREVIOUS_KERNEL_MS = {
    (64, 32, 4096): 1.1396, (128, 64, 1024): 1.7581,
    (128, 128, 1024): 7.5479, (256, 128, 256): 3.0143, (64, 16, 256): 0.1078,
    "stage 1": 0.0579, "stages 2+3": 0.0598,
}
EQUAL_STREAMS = 256

# live ReID: bench.py::bench_livereid's shape (S, N, K, D, objects,
# crop, T) and BoT-SORT's deployed embedding cadence (bench.py DEPLOYED)
LIVE_S, LIVE_N, LIVE_K, LIVE_D, LIVE_OBJ, LIVE_T = 128, 16, 64, 512, 14, 4
CROP_HW = (256, 128)
CADENCE = 8
BLOCK_CHECK_B = 64
# phase 20's card-vs-host int8 check: crops, and the per-crop cosine bar
# (sums in another order may flip a quantized activation by one step; the
# host's bf16 forward is held against the JAX package's, at 0.99999, by
# tests/test_torch_quant.py)
HOST_INT8_CROPS, HOST_INT8_COS = 8, 0.999
EQUAL_T = 12  # frames of the kernel-path-vs-plain-path live runs
# the deployed live-ReID points of bench.py DEPLOYED: an embedding cadence
# or a priority budget. bench_livereid keeps N = LIVE_N (it raises N only
# for --crop-budget, which DEPLOYED does not pass) and embeds
# round(p * S * N) crops a frame at a priority p: StrongSORT 1229,
# HybridSORT 1638, of about 1700 valid crops
STRONG_PRIORITY, HYBRID_PRIORITY = 0.6, 0.8
DEEPOC_CADENCE, BOOST_CADENCE = 8, 2
OC_S = 2048  # bench.py's default stream count (all but SORT and ByteTrack)
# bench.py's live-CMC row (strongsort_cmc_ecc): 512 streams, frames at the
# reference's CMC scale
CMC_S, CMC_SCALE = 512, 0.15
TESTS = Path(__file__).resolve().parent / "tests"
MOT_MINI = Path(__file__).resolve().parent / "assets" / "MOT17-mini" / "train"
TRACKER_NAMES = ("sort", "bytetrack", "ocsort", "deepocsort", "strongsort",
                 "botsort", "boosttrack", "hybridsort", "ucmctrack")
# the trackers whose golden_long sets phase 18 writes through the CLI, a
# spawned process a set: on an H100 (700 W) all nine took 154.5 s one
# after another, so the four that tests/test_torch_cuda.py already runs
# through the CLI on the card (DeepOC-SORT, BoostTrack, HybridSORT,
# UCMCTrack) are left to it
CLI_TRACKERS = ("sort", "bytetrack", "ocsort", "strongsort", "botsort")
TUNE_FRAMES = 8  # scripts/tune.py's default: the bundled GT spans 8 frames
FAILOVER_TICKS = 20  # the flagship failover's ticks, cut in the middle
# phase 21: timed ticks of each harness run and sweep point (the JAX
# package's scripts time 200 and 300; 100 until the script outgrew 900
# s, 60 until phase 28 came), and (b)'s ticks held against the native mux
SLO_TICKS, RING_EQUAL_TICKS = 40, 4
# phase 22: profile_osnet's crops and model (phase 7's widths), its timed
# calls a piece; profile_stages' calls a stage; ablate_cost's trackers,
# streams and frames and its timed rollouts; microbench_select's streams
# and calls a case
PROFILE_CROPS, PROFILE_REPEATS = 2048, 3
STAGE_ITERS = 3
ABLATE_TRACKERS, ABLATE_T, ABLATE_REPEATS = ("bytetrack", "boosttrack"), 30, 2
SELECT_STREAMS, SELECT_REPEATS = 2048, 20
# phase 23: the long-horizon script's defaults (ByteTrack) but its frames,
# OC-SORT's frames, and the leading chunks run again as one run(); cut
# from 10000 (5000 when phase 25 came, 2500 when phase 26 came, 1500, the
# fewest chunks (c) and its profile need, when phase 27 came), 2000
# frames and 4 chunks to keep the script near 900 s (on an H100 at 700 W
# the defaults' run alone takes 100-145 s: ByteTrack at 8-16 ms a
# frame-batch, host-bound, with chunks up to 53 ms)
LONG_FRAMES, LONG_OC_FRAMES, LONG_EQUAL_CHUNKS = 1500, 500, 2
# phase 24: oriented-box SORT (streams, frames, timed runs, streams run
# on the host as well) and the live sparse-flow leg (frames, timed runs,
# streams and frames run on the host as well), their frames cut from 60
# and 30 (an H100 at 700 W takes 71 ms a frame-batch and 516 ms, of them
# 529 ms a frame pair in sof_jax_batch at S=512); the warps' tolerance to
# the pans is tests/test_torch_cmc.py's for sof_jax_batch, the boxes'
# to the host's those of the CPU tests against JAX (tests/test_torch_sort.py,
# tests/test_torch_ecc.py)
OBB_S, OBB_T, OBB_REPEATS, OBB_HOST_S, OBB_BOX_ATOL = 2048, 30, 3, 8, 1e-3
SOF_T, SOF_REPEATS, SOF_HOST_S, SOF_HOST_T = 6, 3, 8, 6
SOF_PAN_ATOL, SOF_BOX_ATOL = 0.05, 1e-2
# phase 25: the ablation scoreboard's frames (the committed tables'); its
# bars: a row's HOTA against the committed JAX row (the JAX package's
# auction-against-JV bar, tests/test_accuracy_synthetic.py::
# test_auction_accuracy_parity_with_jv), and the card's rows against the
# host's plain auction on SCORE_HOST_ROWS (the JAX package's tolerance for
# its committed table, tests/test_accuracy_ablation.py)
SCORE_FRAMES, SCORE_HOTA_BAR, SCORE_HOST_ATOL = 600, 1.0, 0.5
SCORE_HOST_ROWS = ("bytetrack", "boosttrack")
# rows whose middle frame's solves (e) holds to the plain auction and
# times: tracks by detections, (1, 192, 96), and detections by tracks,
# (1, 96, 192), where a lane holds eight of the 192 columns
SCORE_SOLVE_ROWS = ("strongsort", "boosttrack")
# bench.py DEPLOYED's points: BoT-SORT and DeepOC-SORT at cadence 8,
# BoostTrack at cadence 2, StrongSORT and HybridSORT at priority budgets
SCORE_POINTS = ((("botsort", "deepocsort"), {"emb_cadence": CADENCE}),
                (("boosttrack",), {"emb_cadence": BOOST_CADENCE}),
                (("strongsort",), {"emb_budget": STRONG_PRIORITY}),
                (("hybridsort",), {"emb_budget": HYBRID_PRIORITY}))
# phase 26: the worker processes that run the synthetic benchmark's rows,
# one task a row, while this one runs (d)-(f) (the rows with a host ECC on
# the tool's blank 1080p frames take 20-29 s each on the card, the others
# 3-7),
# the rows also run on the host through the plain auction (in the same
# pool), the frame of ByteTrack's row whose solves (b) holds to the plain
# auction and times, the demo-GIF tool's boxes' tolerance to the CPU's, the
# ReID goldens' tracker rows' tolerance (tests/test_reid_fixture.py's), and
# run_benchmark.sh's time limit
SYN_WORKERS = 5
SYN_HOST_ROWS, SYN_SOLVE_FRAME = ("bytetrack", "boosttrack"), 150
GIF_BOX_ATOL, REID_ROW_ATOL, BENCH_SH_TIMEOUT = 1e-4, 0.05, 600
# auction launches of one tick of each tracker's step at the harness's
# configurations (PERF.md section 3)
STEP_LAUNCHES = {"bytetrack": 2, "botsort": 2, "strongsort": 2,
                 "deepocsort": 2, "boosttrack": 1, "hybridsort": 3,
                 "ocsort": 2, "sort": 1, "ucmctrack": 2}
# phase 27: each example's arguments (tests/test_examples.py's sizes;
# simple_tracking and multistream_serving take none), and its tracker and
# steps, from its code: ten and five update() calls; OC-SORT stepped 5
# times and over a 20-frame clip; 5 frames; 3 chunks of 30 frames; the
# moved camera's host and the reference host once a frame each over 10
# frames; 5 ticks; 6 ticks (the service steps every slot each tick, a
# stream present or not). A step launches the auction kernel
# STEP_LAUNCHES[tracker] times whether its frame has detections or not
EXAMPLE_ARGS = {
    "basic_tracking": [], "simple_tracking": [], "functional_core": [],
    "multistream_tpu": ["--streams", "8", "--frames", "5"],
    "multistream_serving": [],
    "stream_rebalance": ["--frames", "10", "--move-at", "5"],
    "moving_camera": ["--streams", "2", "--ticks", "5"],
    "async_serving": ["--streams", "4", "--ticks", "6"],
}
EXAMPLE_STEPS = {
    "basic_tracking": ("bytetrack", 10), "simple_tracking": ("bytetrack", 5),
    "functional_core": ("ocsort", 5 + 20),
    "multistream_tpu": ("bytetrack", 5),
    "multistream_serving": ("bytetrack", 3 * 30),
    "stream_rebalance": ("bytetrack", 2 * 10),
    "moving_camera": ("botsort", 5), "async_serving": ("bytetrack", 6),
}
# multistream_serving's frame (of 90) whose solves (d) holds to the plain
# auction and times, and update()'s boxes' tolerance to the CPU's
EXAMPLE_SOLVE_FRAME, EXAMPLE_BOX_ATOL = 45, 1e-3
# phase 28: the scoreboard's timed runs after its warm-up in (a)-(d) (its
# default is 5), and (a)'s time limit
BENCH_REPEATS, BENCH_QUICK_TIMEOUT = 1, 600


def check(ok, msg):
    if not ok:
        raise CheckFailure(msg)


def auction_inputs(rng, P, k, n):
    """Seeded problems of every class the kernel must agree on: random
    masks and thresholds, +inf and negative costs, empty problems, and a
    quarter of dense uniform near-tie problems at thresh 0.9."""
    cost = rng.random((P, k, n)).astype(np.float32)
    cost[rng.random((P, k, n)) < 0.05] = np.inf
    cost[rng.random(P) < 0.1] -= 1.0
    rm = rng.random((P, k)) < 0.7
    cm = rng.random((P, n)) < 0.7
    rm[rng.random(P) < 0.02] = False
    th = rng.choice(np.float32([0.5, 0.7, 0.8, 0.9]), P)
    q = P // 4
    cost[:q] = rng.uniform(0, 1, (q, k, n))
    rm[:q] = rng.random((q, k)) < 0.5
    cm[:q] = rng.random((q, n)) < 0.6
    th[:q] = 0.9
    return [torch.from_numpy(a).cuda() for a in (cost, rm, cm, th)]


def baseline_solver(source):
    """solve() of another auction kernel source with the same C interface
    as csrc/auction.cu, built with the same flags; its launches are not
    counted."""
    import ctypes
    from pathlib import Path

    from motcpp_tpu_torch import cuda_build
    from motcpp_tpu_torch.ops import auction, auction_cuda

    lib = ctypes.CDLL(str(cuda_build.build(Path(source).resolve(),
                                           auction_cuda.NVCC_FLAGS,
                                           "auction_baseline")))
    ptr = ctypes.c_void_p
    lib.auction_solve.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int, ptr, ptr, ptr]
    lib.auction_solve.restype = ctypes.c_int

    def solve(cost, rm, cm, th):
        P, k, n = cost.shape
        r2c = torch.empty((P, k), dtype=torch.int32, device=cost.device)
        c2r = torch.empty((P, n), dtype=torch.int32, device=cost.device)
        err = lib.auction_solve(
            cost.data_ptr(), rm.data_ptr(), cm.data_ptr(), th.data_ptr(), P,
            k, n, auction.EPS_FRAC, auction.MAX_ROUNDS, r2c.data_ptr(),
            c2r.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"baseline kernel launch failed with CUDA error {err}")
        return r2c, c2r

    return solve


def baseline_ms(baseline, key, args):
    """The other kernel's time on these inputs: measured when --baseline
    was given (and checked against the plain auction), else PERF.md's
    record of the previous kernel, else None."""
    if baseline is None:
        return PREVIOUS_KERNEL_MS.get(key), "previous kernel (PERF.md run J)"
    from motcpp_tpu_torch.ops import auction

    err = matching_err(baseline(*args), auction.solve_lap_auction(*args))
    check(err == 0, f"baseline kernel and plain auction disagree at {key}")
    return call_ms(lambda: baseline(*args), 10)[0], "baseline kernel"


def matching_err(got, want):
    """Largest absolute difference of row2col and col2row (0 if equal)."""
    return max(int((g - w).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def profile_frames(runner, dets, masks, frames=10):
    """torch.profiler over `frames` frames of the main path, mid-sequence:
    device busy share of the wall time, the auction kernel's share of
    the device time, and the kernels that take the most device time.
    The profiler's own host cost inflates the wall time it sees."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runner.reset()
    half = dets.shape[0] // 2
    runner.run(dets[:half], masks[:half])
    sl = slice(half, half + frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(dets[sl], masks[sl])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    launched = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in launched)
    if not device_us:
        return "profiler recorded no device time: busy share not measured"
    auction_us = sum(e.self_device_time_total for e in launched
                     if "auction" in e.key)
    # device time attributed to the PyTorch operator that launched it
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    top = "; ".join(
        f"{e.key} {e.self_device_time_total / frames / 1e3:.4f} ms "
        f"x{e.count // frames}" for e in ops[:6])
    return (f"{frames} frames: wall {wall_us / frames / 1e3:.3f} ms/frame "
            f"under the profiler, device busy {device_us / frames / 1e3:.3f} "
            f"ms/frame ({100 * device_us / wall_us:.1f}% of wall), auction "
            f"kernel {auction_us / frames / 1e3:.4f} ms/frame "
            f"({100 * auction_us / device_us:.1f}% of device time), "
            f"{sum(e.count for e in launched) // frames} kernels/frame; "
            f"top operators by device time per frame: {top}")


def scoreboard(tracker, live=False):
    """make(lap) of ``tracker`` at the scoreboard's configuration
    (``scripts/tracker_fns.py``, bench.py's ``build_tracker_fns``) on the
    card: K=64, N=32, or with ``live`` the live-ReID shape (K=LIVE_K,
    N=LIVE_N, embeddings of LIVE_D, ReID on)."""
    from motcpp_tpu_torch.scripts.tracker_fns import build_tracker_fns

    if live:
        return lambda lap: build_tracker_fns(tracker, LIVE_K, LIVE_N, lap,
                                             emb_dim=LIVE_D, device="cuda")
    return lambda lap: build_tracker_fns(tracker, K, N, lap, device="cuda")


def run_smoke(baseline=None):
    from motcpp_tpu_torch.ops import auction, auction_cuda

    # ---- 1. build (both kernels, one nvcc each, started together) ------
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.serving import mux as serving_mux
    from motcpp_tpu_torch.utils import native_io

    def timed(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0

    # the native mux and IO libraries (g++) build beside the two kernels
    # (nvcc)
    with ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(timed, b) for b in (
            auction_cuda.build, osblock_cuda.build, serving_mux.build,
            native_io.build)]
        (lib, build_s), osblock_build, mux_build, io_build = (
            f.result() for f in builds)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    print(f"phase 1 build: {lib.name} in {build_s:.2f} s; ptxas: "
          + " | ".join(ptxas) + f"; card: {smi}")
    if baseline is not None:
        baseline = baseline_solver(baseline)

    # ---- 2. kernel against its plain version -----------------------------
    rng = np.random.default_rng(0)
    max_err = 0
    for k, n, P in CHECK_SHAPES:
        args = auction_inputs(rng, P, k, n)
        got = auction_cuda.solve(*args)
        torch.cuda.synchronize()
        err = matching_err(got, auction.solve_lap_auction(*args))
        max_err = max(max_err, err)
        check(err == 0, f"kernel and plain auction disagree at K={k}, N={n}")
        matched = int((got[0] >= 0).sum())
        k_ms = call_ms(lambda: auction_cuda.solve(*args), 10)[0]
        p_ms = call_ms(lambda: auction.solve_lap_auction(*args), 1)[0]
        o_ms, o_name = baseline_ms(baseline, (k, n, P), args)
        other = "not measured" if o_ms is None else f"{o_ms:.4f} ms"
        print(f"phase 2 kernel=plain K={k} N={n} P={P}: identical "
              f"({matched} matches); kernel {k_ms:.4f} ms, {o_name} {other}, "
              f"plain {p_ms:.2f} ms")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    from auction_cases import EDGE_CASES, edge_case

    for case in sorted(EDGE_CASES):
        args = [torch.from_numpy(a).cuda() for a in edge_case(case)]
        got = auction_cuda.solve(*args)
        torch.cuda.synchronize()
        err = matching_err(got, auction.solve_lap_auction(*args))
        max_err = max(max_err, err)
        check(err == 0, f"kernel and plain auction disagree on {case}")
    print(f"phase 2 kernel=plain on the edge classes "
          f"{', '.join(sorted(EDGE_CASES))}: identical")

    # ---- 3-4. the ByteTrack main path; kernel path against plain path ---
    byte = tracker_path(
        (3, 4), "ByteTrack", S, ("stage 1", "stages 2+3"),
        scoreboard("bytetrack"), smi,
        previous=lambda name, args: baseline_ms(baseline, name, args),
        keep=True)

    # ---- 5-8. the live-ReID BoT-SORT path --------------------------------
    live = live_reid_phases(osblock_build, smi)

    # ---- 9. SORT at bench.py's saturation point ---------------------------
    sort = tracker_path((9, 9), "SORT", S, ("stage 1",), scoreboard("sort"),
                        smi)

    # ---- 10. OC-SORT at bench.py's default stream count ------------------
    ocsort = tracker_path((10, 10), "OC-SORT", OC_S, ("stage 1", "OCR"),
                          scoreboard("ocsort"), smi)

    # ---- 11. StrongSORT live ReID at its deployed priority budget --------
    model, scene = live["model"], live.pop("scene")
    budget = round(STRONG_PRIORITY * LIVE_S * LIVE_N)
    strong = live_tracker_phases(
        11, "StrongSORT", scoreboard("strongsort", live=True),
        ("stage A", "stage B"), model, scene, smi,
        [(f"priority {STRONG_PRIORITY}", None, budget),
         ("every frame", None, None)])

    # ---- 12-14. DeepOC-SORT, BoostTrack and HybridSORT: motion-only at
    #      bench.py's configs (bench.py:96-134), live ReID at DEPLOYED -----
    paths = {"ByteTrack": byte, "BoT-SORT live": live, "SORT": sort,
             "OC-SORT": ocsort, "StrongSORT live": strong}
    trackers = (
        (12, "DeepOC-SORT", "deepocsort", ("stage 1", "OCR"),
         (f"cadence {DEEPOC_CADENCE}", DEEPOC_CADENCE, None)),
        (13, "BoostTrack", "boosttrack", ("stage 1",),
         (f"cadence {BOOST_CADENCE}", BOOST_CADENCE, None)),
        (14, "HybridSORT", "hybridsort", ("stage 1", "BYTE", "rematch"),
         (f"priority {HYBRID_PRIORITY}", None,
          round(HYBRID_PRIORITY * LIVE_S * LIVE_N))),
    )
    for phase, name, tracker, stages, point in trackers:
        paths[name] = tracker_path((phase, phase), name, OC_S, stages,
                                   scoreboard(tracker), smi)
        paths[f"{name} live"] = live_tracker_phases(
            phase, name, scoreboard(tracker, live=True), stages, model,
            scene, smi, [point])

    # ---- 15. UCMCTrack at bench.py's config (bench.py:128-133) -------------
    paths["UCMCTrack"] = tracker_path(
        (15, 15), "UCMCTrack", OC_S, ("stage 1", "stages 2+3"),
        scoreboard("ucmctrack"), smi)

    # ---- 16. live camera motion: bench.py's strongsort_cmc_ecc row --------
    paths["StrongSORT ECC"] = live_ecc_phase(16, smi)

    # ---- 17. the serving runtime: TrackingService over the native mux ------
    served = serving_phase(17, smi, mux_build, byte["frame_ms"],
                           live["frame_ms"]["cadence 8"], model)

    # ---- 18. configs, the CLI's goldens, checkpoint failover, profiling,
    #      the ReID warm-up and the native IO --------------------------------
    utils = utilities_phase(18, smi, io_build, model, served["timers"])

    # ---- 19. streams sharded over devices: the runner, the service, the
    #      collectives and the two-process dryrun ---------------------------
    sharded = sharded_phase(19, smi, byte, live, paths["HybridSORT live"],
                            served["live"], scene)

    # ---- 20. int8 and dense-lite ReID: live BoT-SORT at cadence 8 through
    #      the int8 embed and the auction kernel -----------------------------
    quantized = int8_phase(20, smi, live, served["live"], scene)
    del scene

    # ---- 21. the serving tail-latency harness and the SLO sweep ----------
    tail = serving_tail_phase(21, smi)

    # ---- 22. the time-attribution tools: the per-piece OSNet profile, the
    #      stage microbenchmarks, the stage ablation, the select microbench
    tools = attribution_phase(22, smi, live["osblock"]["ms"])

    # ---- 23. long-horizon streaming: the long-run script ---------------
    longrun = long_horizon_phase(23, smi)

    # ---- 24. oriented-box SORT and the live sparse-flow leg --------------
    obb_sof = obb_sof_phase(24, smi)

    # ---- 25. the ablation accuracy scoreboard with its cadence and
    #      priority-budget probes ----------------------------------------
    scores = scoreboard_phase(25, smi)

    # ---- 26. the accuracy and evaluation tools: the synthetic benchmark,
    #      run_benchmark.sh, the golden regenerators, the GIF tool's tracks
    evaluation = evaluation_tools_phase(26, smi)

    # ---- 27. the examples: motcpp_tpu_torch/examples/ through main() ------
    examples = examples_phase(27, smi)

    # ---- 28. the scoreboard: motcpp_tpu_torch/bench.py -------------------
    scored = bench_phase(28, smi)

    motion = [p for name, p in paths.items() if not name.endswith("live")]
    live_paths = [p for name, p in paths.items() if name.endswith("live")]
    kernels = [{
        "name": "auction",
        "route": "cuda",
        "source": "motcpp_tpu_torch/csrc/auction.cu",
        "replaces": "motcpp_tpu/ops/auction_pallas.py:66",
        "launches": (sum(p["auction_launches"] for p in paths.values())
                     + served["auction_launches"]
                     + utils["auction_launches"]
                     + sharded["auction_launches"]
                     + quantized["auction_launches"]
                     + tail["auction_launches"]
                     + tools["auction_launches"]
                     + longrun["auction_launches"]
                     + obb_sof["auction_launches"]
                     + scores["auction_launches"]
                     + evaluation["auction_launches"]
                     + examples["auction_launches"]
                     + scored["auction_launches"]),
        "max_abs_err": max([max_err, sharded["auction_err"],
                            quantized["auction_err"], tail["auction_err"],
                            tools["auction_err"], longrun["auction_err"],
                            obb_sof["auction_err"], scores["auction_err"],
                            evaluation["auction_err"],
                            examples["auction_err"], scored["auction_err"]]
                           + [p["auction_err"] for p in motion]
                           + [p["auction"]["auction_err"] for p in live_paths
                              if "auction" in p]),
        "ms": byte["ms"],
        "plain_ms": byte["plain_ms"],
        "bound_ms": byte["bound_ms"],
        "bound_by": byte["bound_by"],
        "library_ms": None,
    }, {
        "name": "osblock",
        "route": "cuda",
        "source": "motcpp_tpu_torch/csrc/osblock.cu",
        "replaces": "motcpp_tpu/appearance/osblock_pallas.py:95",
        "launches": (sum(p["osblock_launches"] for p in live_paths)
                     + served["osblock_launches"]
                     + utils["osblock_launches"]
                     + sharded["osblock_launches"]
                     + quantized["osblock_launches"]
                     + tools["osblock_launches"]
                     + scored["osblock_launches"]),
        "max_abs_err": max([sharded["osblock_err"], tools["osblock_err"],
                            scored["osblock_err"]]
                           + [p["osblock"]["max_err"] for p in live_paths]),
        "ms": live["osblock"]["ms"],
        "plain_ms": live["osblock"]["plain_ms"],
        "bound_ms": live["osblock"]["bound_ms"],
        "bound_by": live["osblock"]["bound_by"],
        "library_ms": None,
    }]
    for name, p in paths.items():
        print(f"launches on the {name} path: auction {p['auction_launches']}"
              + (f", OSBlock {p['osblock_launches']}"
                 if "osblock_launches" in p else ""))
    print(f"launches on the serving paths: auction "
          f"{served['auction_launches']}, OSBlock "
          f"{served['osblock_launches']}")
    print(f"launches on phase 18's paths: auction "
          f"{utils['auction_launches']}, OSBlock {utils['osblock_launches']}")
    print(f"launches on phase 19's sharded paths: auction "
          f"{sharded['auction_launches']}, OSBlock "
          f"{sharded['osblock_launches']}")
    print(f"launches on phase 20's int8 paths: auction "
          f"{quantized['auction_launches']}, OSBlock "
          f"{quantized['osblock_launches']}, int8 products (torch._int_mm, "
          f"not a kernel of this port) {quantized['int8_launches']}")
    print(f"launches on phase 21's serving harness and sweep: auction "
          f"{tail['auction_launches']}")
    print(f"launches on phase 22's tools: auction {tools['auction_launches']}"
          f", OSBlock {tools['osblock_launches']}")
    print(f"launches on phase 23's long runs: auction "
          f"{longrun['auction_launches']}")
    print(f"launches on phase 24's OBB SORT and live SOF paths: auction "
          f"{obb_sof['auction_launches']}")
    print(f"launches on phase 25's scoreboard rows: auction "
          f"{scores['auction_launches']}")
    print(f"launches on phase 26's synthetic benchmark rows: auction "
          f"{evaluation['auction_launches']}")
    print(f"launches on phase 27's examples: auction "
          f"{examples['auction_launches']}")
    print(f"launches on phase 28's scoreboard rows: auction "
          f"{scored['auction_launches']}, OSBlock "
          f"{scored['osblock_launches']}")
    return kernels, smi


def tracker_path(phases, label, n_streams, stage_names, make, card,
                 previous=None, keep=False):
    """A tracker's multi-stream main path through the auction kernel and
    its checks: one warm-up and REPEATS timed run()s of T frames from a
    reset state, each launching the kernel len(stage_names) times a
    frame; the kernel on the inputs the path gives it mid-sequence,
    beside its plain version and its bound; a profile of 10 frames; and
    (phase ``phases[1]``) the same rollout on EQUAL_STREAMS streams
    through the kernel and through the plain auction. ``make(lap)``
    returns the tracker's (init_fn, step_fn); ``card`` is nvidia-smi's
    name and power limit, printed with the times; ``previous(stage name,
    args)``, given for ByteTrack, returns the previous auction kernel's
    ms on the stage's inputs and what was timed (see ``baseline_ms``).
    With ``keep`` the result also holds the path's inputs and the last
    timed run's outputs on the card (for phase 19)."""
    from motcpp_tpu_torch.data import synth_stream_dets
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    phase, eq_phase = phases
    per_frame = len(stage_names)
    init, step = make("auction_pallas")
    dets_np, masks_np = synth_stream_dets(np.random.default_rng(0), T,
                                          n_streams, N, n_obj=N_OBJ)
    dets = torch.from_numpy(dets_np).cuda()
    masks = torch.from_numpy(masks_np).cuda()
    runner = MultiStreamRunner(init, step, n_streams, device="cuda")

    auction_cuda.LAUNCHES = 0
    times, emitted = [], 0
    for rep in range(1 + REPEATS):
        runner.reset()
        before = auction_cuda.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, out_masks = runner.run(dets, masks)
        torch.cuda.synchronize()
        if rep:
            times.append(time.perf_counter() - t0)
        check(auction_cuda.LAUNCHES - before == per_frame * T,
              f"{label} run {rep}: {auction_cuda.LAUNCHES - before} kernel "
              f"launches, want {per_frame * T}")
        emitted = int(out_masks.sum())
    launches = auction_cuda.LAUNCHES
    check(launches > 0, f"the {label} path never launched the kernel")
    check(outs.shape == (T, n_streams, K, 8)
          and out_masks.shape == (T, n_streams, K),
          f"{label} output shapes {tuple(outs.shape)}, "
          f"{tuple(out_masks.shape)}")
    check(emitted > 0, f"the {label} path emitted no tracks")
    check(bool(torch.isfinite(outs[out_masks]).all()),
          f"{label}: non-finite emitted boxes")
    run_s = float(np.median(times))
    fps = n_streams * T / run_s
    print(f"phase {phase} {label} main path S={n_streams} K={K} N={N} T={T}: "
          f"{run_s * 1e3 / T:.3f} ms per frame-batch (median of "
          f"{REPEATS}, runs {[round(t * 1e3, 1) for t in times]} ms), "
          f"{fps:.0f} frames/s, {fps / 30:.0f} streams at 30 FPS, {emitted} "
          f"emissions in the last run, {launches} kernel launches "
          f"({launches // (1 + REPEATS)} per run); card: {card}")

    # the kernel on the inputs the main path gives it, mid-sequence
    runner.reset()
    runner.run(dets[: T // 2], masks[: T // 2])
    stats = auction_on_path(
        phase, label, stage_names,
        lambda: runner.run(dets[T // 2: T // 2 + 1],
                           masks[T // 2: T // 2 + 1]), card, previous)
    print(f"phase {phase} {label} profile: "
          f"{profile_frames(runner, dets, masks)}")

    # kernel path against the plain path
    d, m = dets[:, :EQUAL_STREAMS], masks[:, :EQUAL_STREAMS]
    results = {}
    for lap in ("auction_pallas", "auction"):
        i_fn, s_fn = make(lap)
        results[lap] = MultiStreamRunner(i_fn, s_fn, EQUAL_STREAMS,
                                         device="cuda").run(d, m)
    (ko, km), (po, pm) = results["auction_pallas"], results["auction"]
    check(torch.equal(km, pm),
          f"{label}: kernel and plain paths emit different masks")
    check(torch.equal(ko[km], po[pm]),
          f"{label}: kernel and plain paths emit different ids or boxes")
    print(f"phase {eq_phase} {label} kernel path = plain path on "
          f"{EQUAL_STREAMS} streams: identical ({int(km.sum())} emissions)")
    result = dict(stats, auction_launches=launches, frame_ms=run_s * 1e3 / T)
    if keep:
        result.update(inputs=(dets, masks), outputs=(outs, out_masks))
    return result


def auction_on_path(phase, label, stage_names, run_frame, card,
                    previous=None):
    """The auction kernel on the inputs a path gives it: ``run_frame()``
    runs one frame, whose solves (one per stage name) are captured and
    each timed beside the plain auction and its bound; returns the
    per-frame sums and the largest difference from the plain auction
    (which must be 0). ``previous`` is as in ``tracker_path``."""
    with captured_solves() as captured:
        run_frame()
    return solves_on_path(phase, label, stage_names, captured, card,
                          previous)


@contextlib.contextmanager
def captured_solves(when=None):
    """While inside, the auction kernel's wrapper copies its inputs into
    the list this yields, on each call for which ``when()`` is true (on
    every call when ``when`` is None), and solves as it does outside."""
    from motcpp_tpu_torch.ops import auction_cuda

    captured, solve = [], auction_cuda.solve

    def recording_solve(*args):
        if when is None or when():
            captured.append([t.clone() for t in args])
        return solve(*args)

    auction_cuda.solve = recording_solve
    try:
        yield captured
    finally:
        auction_cuda.solve = solve


def solves_on_path(phase, label, stage_names, captured, card,
                   previous=None):
    """The auction kernel on one frame's captured solves (one per stage
    name), each held to the plain auction (max abs err 0) and timed
    beside it and its bound; returns as :func:`auction_on_path`."""
    from motcpp_tpu_torch.ops import auction, auction_cuda

    solve = auction_cuda.solve
    check(len(captured) == len(stage_names),
          f"{label}: captured {len(captured)} solves, want {len(stage_names)}")
    k_ms = p_ms = b_ms = 0.0
    bound_by, max_err = set(), 0
    for name, args in zip(stage_names, captured):
        err = matching_err(solve(*args), auction.solve_lap_auction(*args))
        max_err = max(max_err, err)
        check(err == 0, f"kernel and plain auction disagree on the {label} "
              f"path's {name}")
        ks = call_ms(lambda: solve(*args), 20)[0]
        ps = call_ms(lambda: auction.solve_lap_auction(*args), 3)[0]
        bs, by = auction_bound_ms(*args)
        other = ""
        if previous is not None:
            o_ms, o_name = previous(name, args)
            other = (f", {o_name} "
                     + ("not measured" if o_ms is None else f"{o_ms:.4f} ms"))
        k_ms, p_ms, b_ms = k_ms + ks, p_ms + ps, b_ms + bs
        bound_by.add(by)
        print(f"phase {phase} kernel on the {label} path's {name} "
              f"{tuple(args[0].shape)}: kernel {ks:.4f} ms{other}, plain "
              f"{ps:.3f} ms, bound {bs:.6f} ms ({by}; whole tiles "
              f"{full_tile_bound_ms(*args):.6f} ms), max abs err {err}")
    print(f"phase {phase} {label} kernel per frame: {k_ms:.4f} ms, plain "
          f"{p_ms:.3f} ms, bound {b_ms:.6f} ms; card: {card}")
    return {"auction_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": "bytes" if bound_by == {"bytes"} else "operations"}


def sass_mma_counts(path):
    """Tensor-core (HMMA) instructions in each instantiation of the
    OSBlock kernel ({"bfloat16": n, "float32": n}), from cuobjdump -sass
    of the built library."""
    from pathlib import Path

    from motcpp_tpu_torch import cuda_build

    cuobjdump = Path(cuda_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = None
            if "osblock_kernel" in name:
                fn = "bfloat16" if "bfloat16" in name else "float32"
                counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def x1_block_inputs(gen):
    """Seeded NHWC inputs of the six osnet_x1_0 blocks at 256x128 crops
    (post-ReLU activations, as the blocks see)."""
    shapes = {"conv2_0": (64, 32, 64), "conv2_1": (64, 32, 256),
              "conv3_0": (32, 16, 256), "conv3_1": (32, 16, 384),
              "conv4_0": (16, 8, 384), "conv4_1": (16, 8, 512)}
    return {name: torch.relu(torch.randn((BLOCK_CHECK_B, *hw), generator=gen,
                                         device="cuda"))
            for name, hw in shapes.items()}


def profile_frame(runner, dets, masks, span, legs):
    """torch.profiler over one frame of a path after two (``legs``: the
    run() keywords beside dets and masks, each (T, ...)): the kernels'
    time and share of the wall; the kernels that ran inside the device
    span of the ``span`` range that the path's wrapper opens ("osnet" or
    "ecc"), split for OSNet into the OSBlock kernel and the rest, and
    the span's length (it also covers the idle gaps between them); the
    kernel time outside the span (the tracker) and the auction kernel's
    part of that; the operators that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runner.reset()
    runner.run(dets[:2], masks[:2], **{k: v[:2] for k, v in legs.items()})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(dets[2:3], masks[2:3],
                   **{k: v[2:3] for k, v in legs.items()})
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the range also appears on the device timeline, as the span from its
    # first kernel's start to its last kernel's end
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e.time_range for e in on_device if e.name == span]
    kernels = [e for e in on_device if e.name != span]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    if not device_us:
        return "profiler recorded no device time: shares not measured"

    def kernel_us(keep):
        return sum(e.time_range.elapsed_us() for e in kernels if keep(e))

    def in_span(e):
        return any(s.start <= e.time_range.start < s.end for s in spans)

    inside_us = kernel_us(in_span)
    block_us = kernel_us(lambda e: span == "osnet" and in_span(e)
                         and "osblock" in e.name)
    auction_us = kernel_us(lambda e: not in_span(e) and "auction" in e.name)
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    top = "; ".join(f"{e.key} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in ops[:8])
    label = {"osnet": "rest of OSNet", "ecc": "ECC"}[span]
    parts = [f"1 frame: wall {wall_us / 1e3:.3f} ms under the profiler, "
             f"kernels {device_us / 1e3:.3f} ms "
             f"({100 * device_us / wall_us:.1f}% of wall)"]
    if span == "osnet":
        parts.append(f"OSBlock kernel {block_us / 1e3:.3f} ms "
                     f"({100 * block_us / device_us:.1f}%)")
    if not spans:
        parts.append(f"no device span of the {span} range: split not "
                     "measured")
    else:
        rest = inside_us - block_us
        span_us = sum(s.elapsed_us() for s in spans)
        parts.append(
            f"{label} {rest / 1e3:.3f} ms ({100 * rest / device_us:.1f}%; "
            f"the {span} range's device span {span_us / 1e3:.3f} ms), "
            f"tracker and the rest {(device_us - inside_us) / 1e3:.3f} ms "
            f"({100 * (device_us - inside_us) / device_us:.1f}%), of it the "
            f"auction kernel {auction_us / 1e3:.4f} ms")
    parts.append(f"{len(kernels)} kernels; top operators by device time: "
                 f"{top}")
    return "; ".join(parts)


def check_live_outputs(label, e, outs, out_masks):
    """Checks of a live-ReID run: the last embeddings finite and of unit
    norm (zero where a crop was not embedded), tracks emitted, their
    boxes finite; returns the emissions."""
    norms = e.norm(dim=1)
    check(bool(torch.isfinite(e).all()), f"{label}: non-finite embeddings")
    nonzero = norms > 0
    check(bool(((norms[nonzero] - 1).abs() < 1e-3).all())
          and int(nonzero.sum()) > 0, f"{label}: embeddings not unit norm")
    emitted = int(out_masks.sum())
    check(emitted > 0, f"{label}: no tracks emitted")
    check(bool(torch.isfinite(outs[out_masks]).all()),
          f"{label}: non-finite emitted boxes")
    return emitted


def osblock_on_path(phase, runner, dets, masks, crops, shards=1):
    """The OSBlock kernel on the inputs a live path gives each block (its
    third frame, after two from a fresh ``runner``; each of ``shards``
    shards embeds its own crops), beside its plain version (float32
    products) and its bound; returns the per-frame sums."""
    from motcpp_tpu_torch.appearance import osblock, osblock_cuda

    runner.run(dets[:2], masks[:2], embs=crops[:2])
    captured = []
    launch = osblock_cuda.osblock

    def recording(w, x):
        captured.append((w, x.clone()))
        return launch(w, x)

    osblock_cuda.osblock = recording
    try:
        runner.run(dets[2:3], masks[2:3], embs=crops[2:3])
    finally:
        osblock_cuda.osblock = launch
    check(len(captured) == 6 * shards,
          f"captured {len(captured)} blocks, want {6 * shards}")
    with exact_float32():
        k_ms = p_ms = b_ms = 0.0
        bound_by, max_err = set(), 0.0
        for w, x in captured:
            got = launch(w, x)
            ref = osblock.osblock_reference(w.folded, w.name, x, w.cout)
            err = float((got.float() - ref.float()).abs().max())
            cos = float(crop_cosine(got, ref).min())
            check(cos >= 0.999,
                  f"main path {w.name}: cosine {cos:.5f} < 0.999")
            max_err = max(max_err, err)
            ks = call_ms(lambda: launch(w, x), 3)[0]
            ps = call_ms(lambda: osblock.osblock_reference(w.folded, w.name, x,
                                                           w.cout), 1)[0]
            bs, by = osblock_bound_ms(w, *x.shape[:3], x.dtype)
            k_ms, p_ms, b_ms = k_ms + ks, p_ms + ps, b_ms + bs
            bound_by.add(by)
            print(f"phase {phase} kernel on the main path's {w.name} "
                  f"{tuple(x.shape)} {str(x.dtype)[6:]}: kernel {ks:.3f} ms, "
                  f"plain {ps:.3f} ms, bound {bs:.4f} ms ({by}), max abs err "
                  f"{err:.4g}, min cosine {cos:.6f}")
        print(f"phase {phase} OSBlock kernel per frame ({len(captured)} "
              f"blocks): {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
            "max_err": max_err}


def auction_paths_equal(label, make, embed, dets, masks, crops):
    """The tracker with the auction kernel and with the plain auction on
    the same embeddings of ``crops`` (every crop embedded): identical
    masks, ids and boxes; returns the emissions."""
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    S_, n = crops.shape[1:3]
    embs = torch.stack([embed(c.reshape(-1, *CROP_HW, 3)).reshape(S_, n, -1)
                        for c in crops])
    emitted = {}
    for lap in ("auction_pallas", "auction"):
        i_fn, s_fn = make(lap)
        emitted[lap] = MultiStreamRunner(i_fn, s_fn, S_, device="cuda",
                                         with_embs=True).run(dets, masks,
                                                             embs=embs)
    (ko, km), (po, pm) = emitted["auction_pallas"], emitted["auction"]
    check(torch.equal(km, pm), f"{label}: kernel and plain auction emit "
          "different masks")
    check(torch.equal(ko[km], po[pm]), f"{label}: kernel and plain auction "
          "emit different ids or boxes")
    return int(km.sum())


def emission_share(runner_for, embed, plain_embed, dets, masks, crops):
    """The live path with the OSBlock kernel's embeddings and with the
    plain (folded) version's: the share of emissions with the same id
    and a box within 1e-3 px, reported (bf16 products round otherwise,
    so a few associations may differ)."""
    paths = {}
    for label, fn in (("kernel", embed), ("plain", plain_embed)):
        paths[label] = runner_for(fn).run(dets, masks, embs=crops)
    (ko, km), (po, pm) = paths["kernel"], paths["plain"]
    same = km & pm & (ko[..., 4] == po[..., 4]) & (
        (ko[..., :4] - po[..., :4]).abs().amax(-1) <= 1e-3)
    share = int(same.sum()) / max(int(km.sum()), int(pm.sum()), 1)
    return (f"{int(km.sum())} vs {int(pm.sum())} emissions, "
            f"{100 * share:.2f}% identical")


def live_reid_phases(osblock_build, card):
    from motcpp_tpu_torch.appearance import osblock, osblock_cuda
    from motcpp_tpu_torch.appearance.osnet import init_params, osnet_x1_0
    from motcpp_tpu_torch.appearance.quant import fold_osnet
    from motcpp_tpu_torch.appearance.reid import make_embed_fn
    from motcpp_tpu_torch.data import synth_stream_dets
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    # ---- 5. build ---------------------------------------------------------
    path, build_s = osblock_build
    ptxas = [ln.strip() for ln in path.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    print(f"phase 5 build: {path.name} in {build_s:.2f} s; ptxas: "
          + " | ".join(ptxas))
    hmma = sass_mma_counts(path)
    check(len(hmma) == 2, f"cuobjdump found {sorted(hmma)}, want the two "
          "instantiations of osblock_kernel")
    check(hmma["bfloat16"] > 0, "the bfloat16 kernel has no HMMA instruction")
    check(hmma["float32"] == 0, f"the float32 kernel has {hmma['float32']} "
          "HMMA instructions (TF32)")
    print(f"phase 5 SASS: HMMA instructions bfloat16 {hmma['bfloat16']}, "
          f"float32 {hmma['float32']}")

    # ---- 6. kernel against its plain version at the x1_0 shapes ----------
    model = init_params(osnet_x1_0(feature_dim=LIVE_D), seed=0)
    folded = fold_osnet(model)
    with exact_float32():
        trees = {dt: {n: {k: v.to("cuda", dt) for k, v in leaf.items()}
                      for n, leaf in folded.items()}
                 for dt in (torch.float32, torch.bfloat16)}
        packs = {dt: osblock.pack_blocks(tree, dt)
                 for dt, tree in trees.items()}
        inputs = x1_block_inputs(torch.Generator(device="cuda").manual_seed(0))
        for name, x in inputs.items():
            w32, w16 = packs[torch.float32][name], packs[torch.bfloat16][name]
            got32 = osblock.osblock_fused(w32, x)
            ref32 = osblock.osblock_reference(trees[torch.float32], name, x,
                                              w32.cout)
            rel = float((got32 - ref32).abs().max() / ref32.abs().max())
            check(rel <= 1e-4, f"{name} float32: kernel vs plain relative "
                  f"error {rel:.2e} > 1e-4")
            xb = x.bfloat16()
            got16 = osblock.osblock_fused(w16, xb)
            ref16 = osblock.osblock_reference(trees[torch.bfloat16], name, xb,
                                              w16.cout)
            cos16 = float(crop_cosine(got16, ref16).min())
            cos32 = float(crop_cosine(got16, ref32).min())
            check(cos16 >= 0.999, f"{name} bf16: cosine {cos16:.5f} < 0.999 "
                  f"against the plain version in bf16")
            check(cos32 >= 0.995, f"{name} bf16: cosine {cos32:.5f} < 0.995 "
                  f"against float32")
            _, H, W, _ = x.shape
            line = [f"phase 6 {name} B={BLOCK_CHECK_B} {H}x{W} "
                    f"{w32.cin}->{w32.cout}: f32 rel err {rel:.2e}, bf16 min "
                    f"cosine {cos16:.6f} (plain bf16) {cos32:.6f} (f32)"]
            for dt, w, xx in ((torch.float32, w32, x),
                              (torch.bfloat16, w16, xb)):
                k_ms = call_ms(lambda: osblock.osblock_fused(w, xx), 3)[0]
                p_ms = call_ms(lambda: osblock.osblock_reference(
                    trees[dt], name, xx, w.cout), 1)[0]
                b_ms, by = osblock_bound_ms(w, BLOCK_CHECK_B, H, W, dt)
                line.append(f"{str(dt)[6:]} kernel {k_ms:.3f} ms plain "
                            f"{p_ms:.3f} ms bound {b_ms:.4f} ms ({by})")
            print("; ".join(line))
    del trees, packs, inputs

    # ---- 7. the live-ReID main path ---------------------------------------
    from torch.profiler import record_function

    embed = make_embed_fn(model, compute_dtype="bfloat16", fused=True,
                          device="cuda")
    last = []

    def embed_fn(crops):
        with record_function("osnet"):
            e = embed(crops)
        last[:] = [e]
        return e

    make_live = scoreboard("botsort", live=True)
    init, step = make_live("auction_pallas")
    dets_np, masks_np = synth_stream_dets(np.random.default_rng(0), EQUAL_T,
                                          LIVE_S, LIVE_N, n_obj=LIVE_OBJ)
    dets_all = torch.from_numpy(dets_np).cuda()
    masks_all = torch.from_numpy(masks_np).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    crops0 = torch.randint(0, 256, (LIVE_S, LIVE_N, *CROP_HW, 3),
                           dtype=torch.uint8, device="cuda", generator=gen)
    # frames differ by a roll along the stream axis, as bench_livereid
    crops_all = rolled_crops(crops0, EQUAL_T)
    dets, masks, crops = (dets_all[:LIVE_T], masks_all[:LIVE_T],
                          crops_all[:LIVE_T])
    counters = (osblock_cuda, auction_cuda)
    want = {osblock_cuda: 6 * LIVE_T, auction_cuda: 2 * LIVE_T}
    frame_ms, outputs = {}, {}
    for label, cadence in (("every frame", None), ("cadence 8", CADENCE)):
        runner = MultiStreamRunner(init, step, LIVE_S, device="cuda",
                                   embed_fn=embed_fn, emb_cadence=cadence)
        if cadence is None:
            osblock_cuda.LAUNCHES = 0
            auction_cuda.LAUNCHES = 0
        run_s, times, _, (outs, out_masks) = timed_runs(
            runner, dets, masks, counters, want, label, REPEATS, embs=crops)
        if cadence is None:
            launches = {m: m.LAUNCHES for m in counters}
        emitted = check_live_outputs(label, last[0], outs, out_masks)
        per_frame = (LIVE_S * LIVE_N if cadence is None
                     else -(-LIVE_S // cadence) * LIVE_N)
        fps = LIVE_S * LIVE_T / run_s
        frame_ms[label] = run_s * 1e3 / LIVE_T
        outputs[label] = (outs, out_masks)
        print(f"phase 7 live ReID {label}: S={LIVE_S} N={LIVE_N} K={LIVE_K} "
              f"D={LIVE_D} osnet_x1_0 bf16 {CROP_HW[0]}x{CROP_HW[1]} T={LIVE_T}"
              f": {run_s * 1e3 / LIVE_T:.3f} ms per frame-batch (median "
              f"of {REPEATS}, runs {[round(t * 1e3, 1) for t in times]} ms), "
              f"{fps / 30:.2f} streams at 30 FPS, "
              f"{per_frame * LIVE_T / run_s:.0f} crops/s ({per_frame} per "
              f"frame), {emitted} emissions in the last run; card: {card}")

    # the kernel on the inputs the main path gives each block (frame 2)
    block_stats = osblock_on_path(7, MultiStreamRunner(
        init, step, LIVE_S, device="cuda", embed_fn=embed), dets, masks, crops)
    runner = MultiStreamRunner(init, step, LIVE_S, device="cuda",
                               embed_fn=embed_fn)
    profiled = profile_frame(runner, dets, masks, "osnet", {"embs": crops})
    print(f"phase 7 profile: {profiled}")

    # ---- 8. kernel path against the plain path ----------------------------
    with exact_float32():
        flat = crops0[:CADENCE * 2].reshape(-1, *CROP_HW, 3)
        e_kernel = make_embed_fn(model, fused=True, device="cuda")(flat)
        e_plain = make_embed_fn(model, folded=True, device="cuda")(flat)
        cos = float((e_kernel * e_plain).sum(1).min())
        check(cos >= 0.9999, f"float32 fused vs folded embeddings: min cosine "
              f"{cos:.6f} < 0.9999")
        print(f"phase 8 float32 embeddings of {flat.shape[0]} crops, fused "
              f"(kernel) vs folded (plain): min cosine {cos:.7f}")

    n_eq = auction_paths_equal("BoT-SORT", make_live, embed, dets_all,
                               masks_all, crops_all)
    print(f"phase 8 BoT-SORT auction kernel = plain auction on {LIVE_S} "
          f"streams x {EQUAL_T} frames of the same embeddings: identical "
          f"({n_eq} emissions)")
    plain_embed = make_embed_fn(model, compute_dtype="bfloat16", folded=True,
                                device="cuda")
    share = emission_share(
        lambda fn: MultiStreamRunner(init, step, LIVE_S, device="cuda",
                                     embed_fn=fn),
        embed, plain_embed, dets_all, masks_all, crops_all)
    print(f"phase 8 live path, kernel vs plain (folded) bf16 embeddings, "
          f"{LIVE_S} streams x {EQUAL_T} frames: {share}")

    return {"model": model, "osblock": block_stats, "frame_ms": frame_ms,
            "outputs": outputs, "make": (init, step),
            "scene": (dets_all, masks_all, crops_all),
            "osblock_launches": launches[osblock_cuda],
            "auction_launches": launches[auction_cuda]}


def live_tracker_phases(phase, name, make, stages, model, scene, card,
                        points):
    """Phase ``phase``: a tracker's live-ReID path (bench.py::bench_livereid's
    shape, osnet_x1_0 bf16 fused) through both kernels at each of
    ``points``, a list of (label, emb_cadence, crop_budget): one warm-up
    and REPEATS timed run()s of LIVE_T frames, with the kernels' launch
    counts checked. The first point is the tracker's deployed one
    (bench.py DEPLOYED); there the OSBlock kernel runs on the path's own
    inputs, one frame is profiled, the auction kernel path is held
    against the plain auction on the same embeddings, and the share of
    identical emissions with the kernel's and the plain version's
    embeddings is reported, and the auction kernel runs on the path's own
    inputs. ``make(lap)`` returns (init_fn, step_fn); ``stages`` names
    the auction launches of a frame; ``scene`` the
    (dets, masks, crops) of EQUAL_T frames; ``card`` nvidia-smi's name and
    power limit."""
    from torch.profiler import record_function

    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.appearance.reid import make_embed_fn
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    embed = make_embed_fn(model, compute_dtype="bfloat16", fused=True,
                          device="cuda")
    last = []

    def embed_fn(crops):
        with record_function("osnet"):
            e = embed(crops)
        last[:] = [e]
        return e

    dets_all, masks_all, crops_all = scene
    dets, masks, crops = (dets_all[:LIVE_T], masks_all[:LIVE_T],
                          crops_all[:LIVE_T])
    valid = masks.sum((1, 2))
    init, step = make("auction_pallas")
    counters = (osblock_cuda, auction_cuda)
    want = {osblock_cuda: 6 * LIVE_T, auction_cuda: len(stages) * LIVE_T}
    launches = {m: 0 for m in counters}
    result = {}
    for i, (label, cadence, budget) in enumerate(points):
        # a priority budget that every frame's valid crops exceed, or the
        # priority only orders crops and never chooses among them
        check(budget is None or int(valid.min()) > budget,
              f"{name} {label}: budget {budget} does not bind "
              f"(fewest valid crops {int(valid.min())})")

        def runner_for(fn, cadence=cadence, budget=budget):
            return MultiStreamRunner(init, step, LIVE_S, device="cuda",
                                     embed_fn=fn, crop_budget=budget,
                                     emb_cadence=cadence,
                                     emb_priority=budget is not None)

        for m in counters:
            m.LAUNCHES = 0
        run_s, times, _, (outs, out_masks) = timed_runs(
            runner_for(embed_fn), dets, masks, counters, want,
            f"{name} {label}", REPEATS, embs=crops)
        for m in counters:
            launches[m] += m.LAUNCHES
        emitted = check_live_outputs(f"{name} {label}", last[0], outs,
                                     out_masks)
        result.setdefault("frame_ms", {})[label] = run_s * 1e3 / LIVE_T
        if budget is not None:
            per_crops = budget
            load = (f" budget={budget} of {float(valid.float().mean()):.0f} "
                    f"valid crops a frame on average (fewest "
                    f"{int(valid.min())})")
        else:
            per_crops = -(-LIVE_S // (cadence or 1)) * LIVE_N
            load = ""
        fps = LIVE_S * LIVE_T / run_s
        print(f"phase {phase} {name} live ReID {label}: S={LIVE_S} N={LIVE_N} "
              f"K={LIVE_K} D={LIVE_D} osnet_x1_0 bf16 "
              f"{CROP_HW[0]}x{CROP_HW[1]} T={LIVE_T}{load}: "
              f"{run_s * 1e3 / LIVE_T:.3f} ms per frame-batch (median of "
              f"{REPEATS}, runs "
              f"{[round(t * 1e3, 1) for t in times]} ms), {fps / 30:.2f} "
              f"streams at 30 FPS, {per_crops * LIVE_T / run_s:.0f} crops/s "
              f"({per_crops} per frame), {emitted} emissions in the last run, "
              f"launches per run: OSBlock {want[osblock_cuda]}, auction "
              f"{want[auction_cuda]}; card: {card}")
        if i:
            continue
        result["osblock"] = osblock_on_path(phase, runner_for(embed), dets,
                                            masks, crops)
        runner = runner_for(embed)
        runner.run(dets[:2], masks[:2], embs=crops[:2])
        result["auction"] = auction_on_path(
            phase, f"{name} live", stages,
            lambda: runner.run(dets[2:3], masks[2:3], embs=crops[2:3]), card)
        profiled = profile_frame(runner_for(embed_fn), dets, masks, "osnet",
                                 {"embs": crops})
        print(f"phase {phase} {name} profile: {profiled}; card: {card}")
        n_eq = auction_paths_equal(name, make, embed, dets_all, masks_all,
                                   crops_all)
        print(f"phase {phase} {name} auction kernel = plain auction on "
              f"{LIVE_S} streams x {EQUAL_T} frames of the same embeddings: "
              f"identical ({n_eq} emissions)")
        plain_embed = make_embed_fn(model, compute_dtype="bfloat16",
                                    folded=True, device="cuda")
        share = emission_share(runner_for, embed, plain_embed, dets_all,
                               masks_all, crops_all)
        print(f"phase {phase} {name} live path at {label}, kernel vs plain "
              f"(folded) bf16 embeddings, {LIVE_S} streams x {EQUAL_T} "
              f"frames: {share}")
    result.update(osblock_launches=launches[osblock_cuda],
                  auction_launches=launches[auction_cuda])
    return result


def live_ecc_phase(phase, card):
    """Phase ``phase``: bench.py's strongsort_cmc_ecc row. StrongSORT
    (n_init=1, gallery_cap=16, no embeddings) under MultiStreamRunner
    with cmc_fn=ecc_jax_batch at CMC scale 0.15, CMC_S streams of T
    frames of panning 162x288 textures made on the card: the warps of
    one frame pair against the known pans; one warm-up and REPEATS timed
    run()s (2*T auction launches each); the ECC's device time on one
    frame pair; the auction kernel on the path's inputs; a profile of
    one frame; the live rollout against a with_warps rollout fed the
    same estimator's warps frame by frame, split across two run()
    calls; and a run without camera motion, which must differ."""
    from torch.profiler import record_function

    from motcpp_tpu_torch.data import pan_frames, synth_stream_dets
    from motcpp_tpu_torch.motion.cmc import ecc_jax_batch
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner

    fh, fw = int(1080 * CMC_SCALE), int(1920 * CMC_SCALE)
    frames, pans = pan_frames(T, CMC_S, fh, fw,
                              torch.Generator(device="cuda").manual_seed(0))
    gb = frames.numel() * 4 / 1e9
    # the warps recover each stream's pan: cur(x) = prev(x + pan)
    w, ok = ecc_jax_batch(frames[0], frames[1])
    err_x = float((w[:, 0, 2] + pans.float()).abs().max())
    err_y = float(w[:, 1, 2].abs().max())
    check(bool(ok.all()), f"ECC failed on {int((~ok).sum())} streams")
    check(err_x <= 1e-3 and err_y <= 1e-3, f"ECC warps miss the pans by "
          f"{err_x:.2e} px in x, {err_y:.2e} px in y (> 1e-3)")
    ecc_ms = call_ms(lambda: ecc_jax_batch(frames[0], frames[1]), 5)[0]
    ecc_bound = 2 * frames[0].numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(f"phase {phase} ECC on one frame pair, S={CMC_S} "
          f"{tuple(frames.shape[2:])}: warps x = -pan within {err_x:.2e} px,"
          f" y within {err_y:.2e} px, ok on every stream; {ecc_ms:.3f} ms "
          f"of device time (the two frames read once at the HBM rate: "
          f"{ecc_bound:.4f} ms); frames {tuple(frames.shape)} float32, "
          f"{gb:.2f} GB on the card")

    def ecc_fn(prev, cur):
        with record_function("ecc"):
            return ecc_jax_batch(prev, cur)

    make = scoreboard("strongsort")
    init, step = make("auction_pallas")
    dets_np, masks_np = synth_stream_dets(np.random.default_rng(0), T,
                                          CMC_S, N, n_obj=N_OBJ)
    dets = torch.from_numpy(dets_np).cuda()
    masks = torch.from_numpy(masks_np).cuda()
    runner = MultiStreamRunner(init, step, CMC_S, device="cuda",
                               cmc_fn=ecc_fn, cmc_scale=CMC_SCALE)
    auction_cuda.LAUNCHES = 0
    times = []
    for rep in range(1 + REPEATS):
        runner.reset()
        before = auction_cuda.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, out_masks = runner.run(dets, masks, frames=frames)
        torch.cuda.synchronize()
        if rep:
            times.append(time.perf_counter() - t0)
        check(auction_cuda.LAUNCHES - before == 2 * T,
              f"live ECC run {rep}: {auction_cuda.LAUNCHES - before} kernel "
              f"launches, want {2 * T}")
    launches = auction_cuda.LAUNCHES
    emitted = int(out_masks.sum())
    check(outs.shape == (T, CMC_S, K, 8) and emitted > 0
          and bool(torch.isfinite(outs[out_masks]).all()),
          f"live ECC: output {tuple(outs.shape)}, {emitted} emissions")
    run_s = float(np.median(times))
    print(f"phase {phase} StrongSORT live ECC main path S={CMC_S} K={K} "
          f"N={N} T={T}, frames {tuple(frames.shape[2:])} at CMC scale "
          f"{CMC_SCALE}: {run_s * 1e3 / T:.3f} ms per frame-batch (median of "
          f"{REPEATS}, runs {[round(t * 1e3, 1) for t in times]} ms), "
          f"{CMC_S * T / run_s / 30:.1f} streams at 30 FPS, {emitted} "
          f"emissions in the last run, {launches} kernel launches "
          f"({launches // (1 + REPEATS)} per run); card: {card}")

    runner.reset()
    runner.run(dets[: T // 2], masks[: T // 2], frames=frames[: T // 2])
    sl = slice(T // 2, T // 2 + 1)
    stats = auction_on_path(
        phase, "StrongSORT live ECC", ("stage A", "stage B"),
        lambda: runner.run(dets[sl], masks[sl], frames=frames[sl]), card)
    print(f"phase {phase} StrongSORT live ECC profile: "
          f"{profile_frame(runner, dets, masks, 'ecc', {'frames': frames})}; "
          f"card: {card}")

    # the live leg against the same estimator's warps fed frame by frame
    scale = float(np.float32(1.0 / CMC_SCALE))
    warps = torch.empty((T, CMC_S, 2, 3), device="cuda")
    warps[0] = torch.eye(2, 3, device="cuda")
    for t in range(1, T):
        w, _ = ecc_jax_batch(frames[t - 1], frames[t])
        warps[t] = torch.cat([w[..., :2], w[..., 2:] * scale], -1)
    fed = MultiStreamRunner(init, step, CMC_S, device="cuda",
                            with_warps=True).run(dets, masks, warps=warps)
    live = MultiStreamRunner(init, step, CMC_S, device="cuda",
                             cmc_fn=ecc_jax_batch, cmc_scale=CMC_SCALE)
    half = T // 2
    parts = [live.run(dets[sl], masks[sl], frames=frames[sl])
             for sl in (slice(0, half), slice(half, T))]
    lo, lm = (torch.cat([p[i] for p in parts]) for i in range(2))
    check(torch.equal(lm, fed[1]), "live ECC: masks differ from the rollout "
          "fed the same warps")
    box_err = float((lo[lm] - fed[0][fed[1]]).abs().max())
    check(box_err <= 1e-4, f"live ECC: boxes differ from the rollout fed "
          f"the same warps by {box_err:.2e} (> 1e-4)")
    po, pm = MultiStreamRunner(init, step, CMC_S, device="cuda").run(dets,
                                                                     masks)
    check(not (torch.equal(pm, lm) and torch.equal(po[pm], lo[lm])),
          "live ECC: a run without camera motion emits the same tracks")
    print(f"phase {phase} live ECC over two run() calls = rollout fed the "
          f"estimator's warps: identical masks ({int(lm.sum())} emissions), "
          f"boxes within {box_err:.2e}; without camera motion "
          f"{int(pm.sum())} emissions, {int((pm != lm).sum())} slots differ")
    del frames
    return dict(stats, auction_launches=launches)


def serve_ticks(svc, submit, ticks, want, timer=None):
    """Drives ``svc`` for ``ticks`` ticks. ``submit(t)`` queues tick t's
    frames (untimed, as producers would), then one step is timed: the
    whole tick, its assemble (the mux), its dispatch (the rest of
    step_async: the copies to the card and the launches) and its fetch
    (result(): the wait for the card and the copy back), and the bytes
    sent to the card are counted, with the host time of staging them
    (part of the dispatch). Each tick must launch each kernel module of
    ``want`` ({module: count}) that many times. ``timer``
    (utils/profiling.py::FrameTimer) also times every tick after the
    first. Returns the batches and per tick (tick s, assemble s,
    dispatch s, fetch s, bytes, staging s)."""
    assemble, put = svc.mux.assemble, svc._put
    clock = {}

    def timed_assemble():
        t0 = time.perf_counter()
        out = assemble()
        clock["assemble"] = time.perf_counter() - t0
        return out

    def counted_put(a, *args):
        t0 = time.perf_counter()
        out = put(a, *args)
        clock["staging"] += time.perf_counter() - t0
        clock["bytes"] += out.numel() * out.element_size()
        return out

    svc.mux.assemble, svc._put = timed_assemble, counted_put
    batches, rows = [], []
    try:
        for t in range(ticks):
            submit(t)
            before = {m: m.LAUNCHES for m in want}
            clock["bytes"] = clock["staging"] = 0
            with (timer if timer is not None and t > 0
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                pending = svc.step_async()
                t1 = time.perf_counter()
                batches.append(pending.result())
                t2 = time.perf_counter()
            for m, n in want.items():
                check(m.LAUNCHES - before[m] == n, f"serving tick {t}: "
                      f"{m.LAUNCHES - before[m]} {m.__name__} launches, "
                      f"want {n}")
            rows.append((t2 - t0, clock["assemble"],
                         t1 - t0 - clock["assemble"], t2 - t1,
                         clock["bytes"], clock["staging"]))
    finally:
        del svc.mux.assemble, svc._put
    return batches, np.asarray(rows)


def tick_report(rows):
    """Median and maximum tick and the medians of its split."""
    ms = rows[:, :4] * 1e3
    med = np.median(ms, 0)
    return (f"tick median {med[0]:.3f} ms, max {ms[:, 0].max():.3f} ms "
            f"(ticks {[round(float(x), 1) for x in ms[:, 0]]}); split "
            f"(medians): assemble {med[1]:.3f} ms, dispatch {med[2]:.3f} ms "
            f"(of it staging the copies to the card "
            f"{np.median(rows[:, 5]) * 1e3:.3f} ms), fetch {med[3]:.3f} ms; "
            f"{rows[:, 4].mean() / 1e6:.3f} MB sent to the card a tick")


def profile_tick(svc, submit):
    """torch.profiler over one step() after ``submit()``: the tick's wall
    under the profiler, the kernels' device time and count, the device
    time of each kind of copy and fill the trace names, and the share of
    the wall in which the device was busy. Where the trace names no copy
    to the card, the tick's copies to the card are timed apart (the same
    shapes from pinned memory, CUDA events) and added to the busy time,
    so that the share counts every copy the tick makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sent = []  # what the tick copies to the card
    put = svc._put

    def recording_put(a, *args):
        out = put(a, *args)
        sent.append(out)
        return out

    submit()
    torch.cuda.synchronize()
    svc._put = recording_put
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.step()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        del svc._put
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not on_device:
        return "profiler recorded no device time: split not measured"

    copies = {}  # the device's copies and fills, by the trace's name
    for e in on_device:
        if "Memcpy" in e.name or "Memset" in e.name:
            copies[e.name] = (copies.get(e.name, 0)
                              + e.time_range.elapsed_us())
    kernels = [e for e in on_device if e.name not in copies]
    kernel_us = sum(e.time_range.elapsed_us() for e in kernels)
    busy = kernel_us + sum(copies.values())
    listed = ", ".join(f"{name} {t / 1e3:.3f} ms"
                       for name, t in copies.items()) or "none recorded"
    report = (f"wall {wall_us / 1e3:.3f} ms under the profiler, device busy "
              f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall): "
              f"{len(kernels)} kernels {kernel_us / 1e3:.3f} ms; copies and "
              f"fills: {listed}")
    if any("HtoD" in name for name in copies):
        return report
    staged = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in sent]
    h2d_us = 1e3 * call_ms(
        lambda: [b.to("cuda", non_blocking=True) for b in staged], 5)[0]
    nbytes = sum(t.numel() * t.element_size() for t in sent)
    busy += h2d_us
    return (f"{report}; the trace names no copy to the card, so the tick's "
            f"{len(sent)} copies to the card ({nbytes / 1e6:.3f} MB) were "
            f"timed apart from pinned memory: {h2d_us / 1e3:.3f} ms; device "
            f"busy with them {busy / 1e3:.3f} ms "
            f"({100 * busy / wall_us:.1f}% of wall)")


def check_served(label, batches, want_o, want_m, atol=1e-4):
    """The served emissions against the runner's on the same frames:
    identical masks and ids, boxes within ``atol``; returns the
    emissions and the largest difference."""
    got_m = np.stack([b.out_masks for b in batches])
    got_o = np.stack([b.outs for b in batches])
    wm, wo = want_m.cpu().numpy(), want_o.cpu().numpy()
    check(np.array_equal(got_m, wm), f"{label}: served masks differ from "
          f"the runner's in {int((got_m != wm).sum())} slots")
    g, w = got_o[got_m], wo[wm]
    check(np.array_equal(g[:, 4], w[:, 4]),
          f"{label}: served ids differ from the runner's")
    err = float(np.abs(g - w).max()) if g.size else 0.0
    check(err <= atol, f"{label}: served rows differ from the runner's by "
          f"{err:.2e} (> {atol})")
    check(int(got_m.sum()) > 0, f"{label}: no emissions")
    return int(got_m.sum()), err


def serving_phase(phase, card, mux_build, runner_ms, live_runner_ms, model):
    """Phase ``phase``: the serving runtime. TrackingService over the
    native mux (its build checked; no Python fallback), each tick's
    frames submitted untimed and one warm-up tick before the timed ones:
    (1) the ByteTrack flagship, S=4096 streams of phase 3's frames (and
    one more), T timed ticks, 2 auction launches a tick; (2) BoT-SORT
    live ReID at cadence 8 (S=128, N=16, osnet_x1_0 bf16 fused, 256x128
    uint8 crops through the mux, only the scheduled slots' crops sent to
    the card), 2*CADENCE timed ticks so that every slot embeds twice, 6
    OSBlock and 2 auction launches a tick. Each tick timed and split,
    stats() printed, the runner's ms per frame-batch of the same path
    beside it, and the emissions held against the runner's on the same
    frames (and crops). (3) A gappy schedule on 8 streams emits, frame
    for frame, what the dense one emits, bit for bit, and two ticks
    dispatched with step_async before either result() equal two step()
    calls. Returns the kernels' launches on (1) and (2)."""
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.appearance.reid import make_embed_fn
    from motcpp_tpu_torch.data import pack_valid_rows, synth_stream_dets
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
    from motcpp_tpu_torch.serving import StreamMux, TrackingService
    from motcpp_tpu_torch.utils.profiling import FrameTimer

    path, build_s = mux_build
    print(f"phase {phase} build: {path.name} (g++) in {build_s:.2f} s")

    def service(*args, **kw):
        svc = TrackingService.from_tracker(*args, device="cuda", **kw)
        check(isinstance(svc.mux, StreamMux),
              "the service runs the Python mux: the native mux did not load")
        return svc

    # ---- (1) the ByteTrack flagship ----------------------------------------
    # phase 3's frames, one more for the warm-up and one to profile
    dets, masks, _ = pack_valid_rows(*synth_stream_dets(
        np.random.default_rng(0), T + 2, S, N, n_obj=N_OBJ))
    counts = masks.sum(-1)
    init, step = scoreboard("bytetrack")("auction_pallas")
    svc = service("bytetrack", S, max_dets=N, tracker_kw=dict(
        max_tracks=K, lap_impl="auction_pallas"))
    hs = [svc.attach() for _ in range(S)]

    def submit(t):
        for s, h in enumerate(hs):
            svc.submit(h, dets[t, s, :counts[t, s]])

    timers = {"ByteTrack": FrameTimer(n_streams=S),
              "BoT-SORT live": FrameTimer(n_streams=LIVE_S)}
    medians = {}
    auction_cuda.LAUNCHES = 0
    batches, rows = serve_ticks(svc, submit, T + 1, {auction_cuda: 2},
                                timers["ByteTrack"])
    auction_launches = auction_cuda.LAUNCHES
    stats = svc.stats()
    profiled = profile_tick(svc, lambda: submit(T + 1))
    want = MultiStreamRunner(init, step, S, device="cuda").run(
        dets[:T + 1], masks[:T + 1])
    emitted, err = check_served("ByteTrack serving", batches, *want)
    tick_s = medians["ByteTrack"] = float(np.median(rows[1:, 0]))
    print(f"phase {phase} serving ByteTrack S={S} K={K} N={N}, {T} ticks "
          f"after one warm-up: {tick_report(rows[1:])}; {S / tick_s / 30:.0f}"
          f" streams at 30 FPS; the runner on the same path (phase 3) "
          f"{runner_ms:.3f} ms per frame-batch; stats {stats}; emissions = "
          f"the runner's on the same frames ({emitted}, boxes within "
          f"{err:.2e}); auction launches {auction_launches} (2 a tick); "
          f"card: {card}")
    print(f"phase {phase} serving ByteTrack profile of one tick: {profiled}")
    del svc, batches, want

    # ---- (2) BoT-SORT live ReID at cadence 8 -------------------------------
    ticks = 2 * CADENCE + 1
    dets, masks, order = pack_valid_rows(*synth_stream_dets(
        np.random.default_rng(0), ticks + 1, LIVE_S, LIVE_N,
        n_obj=LIVE_OBJ))
    counts = masks.sum(-1)
    # phase 7's crops: frame t's are crops0 rolled by t along the streams
    crops0 = torch.randint(0, 256, (LIVE_S, LIVE_N, *CROP_HW, 3),
                           dtype=torch.uint8, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(0))
    crops_host = crops0.cpu().numpy()
    embed = make_embed_fn(model, compute_dtype="bfloat16", fused=True,
                          device="cuda")
    init, step = scoreboard("botsort", live=True)("auction_pallas")
    svc = service("botsort", LIVE_S, max_dets=LIVE_N, emb_dim=LIVE_D,
                  tracker_kw=dict(with_reid=True, max_tracks=LIVE_K,
                                  lap_impl="auction_pallas"),
                  crop_hw=CROP_HW, embed_fn=embed, emb_cadence=CADENCE)
    check(svc._cad_compact, "cadence_compact is off")
    hs = [svc.attach() for _ in range(LIVE_S)]

    # bound now: (3) below rebinds dets and counts, and phase 19 submits
    # these frames again
    def submit_live_to(svc, hs, t, frames=(dets, counts, order, crops_host)):
        dets, counts, order, crops_host = frames
        for s, h in enumerate(hs):
            n = counts[t, s]
            svc.submit(h, dets[t, s, :n], crops=crops_host[
                (s - t) % LIVE_S][order[t, s, :n]])

    def submit_live(t):
        submit_live_to(svc, hs, t)

    osblock_cuda.LAUNCHES = auction_cuda.LAUNCHES = 0
    batches, rows = serve_ticks(svc, submit_live, ticks,
                                {osblock_cuda: 6, auction_cuda: 2},
                                timers["BoT-SORT live"])
    live_launches = (osblock_cuda.LAUNCHES, auction_cuda.LAUNCHES)
    stats = svc.stats()
    profiled = profile_tick(svc, lambda: submit_live(ticks))
    del svc
    runner = MultiStreamRunner(init, step, LIVE_S, device="cuda",
                               embed_fn=embed, emb_cadence=CADENCE)
    ar = torch.arange(LIVE_S, device="cuda")[:, None]
    parts = []
    for t in range(ticks):
        crops_t = torch.roll(crops0, t, 0)[
            ar, torch.from_numpy(order[t]).cuda()]
        parts.append(runner.run(dets[t:t + 1], masks[t:t + 1],
                                embs=crops_t[None]))
    want = [torch.cat([p[i] for p in parts]) for i in range(2)]
    emitted, err = check_served("BoT-SORT live serving", batches, *want)
    tick_s = medians["BoT-SORT live"] = float(np.median(rows[1:, 0]))
    print(f"phase {phase} serving BoT-SORT live ReID cadence {CADENCE} "
          f"S={LIVE_S} N={LIVE_N} K={LIVE_K} D={LIVE_D} osnet_x1_0 bf16 "
          f"{CROP_HW[0]}x{CROP_HW[1]} crops through the mux, "
          f"{ticks - 1} ticks after one warm-up: {tick_report(rows[1:])}; "
          f"{LIVE_S / tick_s / 30:.2f} streams at 30 FPS; the runner on the "
          f"same path (phase 7) {live_runner_ms:.3f} ms per frame-batch; "
          f"stats {stats}; emissions = the runner's on the same crops "
          f"({emitted}, boxes within {err:.2e}); launches OSBlock "
          f"{live_launches[0]}, auction {live_launches[1]} (6 and 2 a tick); "
          f"card: {card}")
    print(f"phase {phase} serving BoT-SORT live profile of one tick: "
          f"{profiled}")
    live = {"submit_to": submit_live_to, "ticks": ticks, "batches": batches,
            "embed": embed, "frames": (dets, masks, order, crops_host)}
    del want, parts, crops0

    # ---- (3) gappy schedule and pipelined dispatch on 8 streams ------------
    gappy = [1, 0, 1, 1, 0, 0, 1, 1, 1, 0, 1, 1]
    dets, masks, _ = pack_valid_rows(*synth_stream_dets(
        np.random.default_rng(0), 8, 4, N, n_obj=N_OBJ))
    counts = masks.sum(-1)
    runs = {}
    for mode in ("step", "pipelined"):
        svc = service("bytetrack", 8, max_dets=N, tracker_kw=dict(
            max_tracks=K, lap_impl="auction_pallas"))
        hs = [svc.attach() for _ in range(8)]
        batches, pending, seen = [], [], 0
        for t, has in enumerate(gappy):
            for s in range(4):  # streams 0-3 dense, 4-7 gappy
                if t < 8:
                    svc.submit(hs[s], dets[t, s, :counts[t, s]])
                if has:
                    svc.submit(hs[s + 4], dets[seen, s, :counts[seen, s]])
            seen += has
            if mode == "step":
                batches.append(svc.step())
                continue
            pending.append(svc.step_async())
            if len(pending) == 2:  # two ticks in flight, then both resolved
                batches += [p.result() for p in pending]
                pending = []
        runs[mode] = batches
    for a, b in zip(runs["step"], runs["pipelined"]):
        check(np.array_equal(a.outs, b.outs)
              and np.array_equal(a.out_masks, b.out_masks),
              "two step_async ticks in flight differ from two step()s")
    dense = [b for b in runs["step"] if b.present[0]]
    sparse = [b for b in runs["step"] if b.present[4]]
    check(len(dense) == len(sparse) == 8, "the schedules did not run")
    same = emitted = 0
    for a, b in zip(dense, sparse):
        for s in range(4):
            ra = a.outs[s][a.out_masks[s]]
            rb = b.outs[s + 4][b.out_masks[s + 4]]
            same += ra.shape == rb.shape and ra.tobytes() == rb.tobytes()
            emitted += ra.shape[0]
    check(same == 32 and emitted > 0, f"gappy streams differ from dense "
          f"streams on {32 - same} of 32 frames")
    print(f"phase {phase} serving gappy schedule {gappy} on streams 4-7 = "
          f"dense streams 0-3, frame for frame, bit for bit ({emitted} "
          f"emissions); two step_async ticks in flight = two step()s on "
          f"all {len(gappy)} ticks")
    return {"auction_launches": auction_launches + live_launches[1],
            "osblock_launches": live_launches[0], "live": live,
            "timers": {name: (t.report(), medians[name])
                       for name, t in timers.items()}}


def run_service(svc, submit, ticks):
    """One step() per tick of ``ticks`` after ``submit(t)``."""
    out = []
    for t in ticks:
        submit(svc, t)
        out.append(svc.step())
    return out


def same_emissions(got, want):
    """Identical masks, and the emitted rows (ids and boxes) to the bit."""
    return len(got) == len(want) and all(
        np.array_equal(g.out_masks, w.out_masks)
        and g.outs[g.out_masks].tobytes() == w.outs[w.out_masks].tobytes()
        for g, w in zip(got, want))


def failover(label, make, submit, ticks, cut, work, card):
    """The uninterrupted run of ``ticks`` ticks against, for each file
    format, a run cut after ``cut`` ticks: the state saved (timed, with
    the copy off the card), read into a fresh service's _init_states()
    (timed, with the copy to the card) and the other ticks continued
    there. Returns the restored services (for one more tick) and the
    emissions' count."""
    from motcpp_tpu_torch.utils.checkpoint import load_state, save_state

    want = run_service(make(), submit, range(ticks))
    check(sum(int(b.out_masks.sum()) for b in want) > 0,
          f"{label}: no emissions")
    first = make()
    run_service(first, submit, range(cut))
    restored, report = {}, []
    for fmt in ("npz", "pt"):
        path = work / f"{label.replace(' ', '_')}.{fmt}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state(first.states, path)
        save_ms = (time.perf_counter() - t0) * 1e3
        svc = make()
        template = svc._init_states()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = load_state(template, path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        svc.restore(state)  # supersedes the reset of make()'s attach
        got = run_service(svc, submit, range(cut, ticks))
        check(same_emissions(got, want[cut:]),
              f"{label}: the {fmt} failover differs from the uninterrupted "
              "run")
        restored[fmt] = svc
        report.append(f"{fmt} {path.stat().st_size / 1e6:.3f} MB, save "
                      f"{save_ms:.3f} ms, load {load_ms:.3f} ms")
    emitted = sum(int(b.out_masks.sum()) for b in want[cut:])
    print(f"phase 18 (c) {label}: {ticks} ticks uninterrupted = {cut} ticks,"
          f" checkpoint, a fresh service restored, {ticks - cut} ticks, in "
          f"both formats, bit for bit ({emitted} emissions after the cut); "
          f"{'; '.join(report)}; card: {card}")
    return restored


def traced_kernels(tick):
    """Names in the Chrome trace that utils/profiling.py::trace exports
    (as its context closes) around ``tick()``."""
    from motcpp_tpu_torch.utils.profiling import trace

    with tempfile.TemporaryDirectory() as d:
        with trace(d, device="cuda"):
            tick()
            torch.cuda.synchronize()
        (path,) = Path(d).glob("*.pt.trace.json")
        events = json.loads(path.read_text())["traceEvents"]
    return {e.get("name", "") for e in events}


def golden_long_worker(name, root):
    """scripts/regen_golden.py's golden_long set of ``name`` through the
    CLI on the card into ``root``, in a worker process at one torch
    thread. Returns its wall seconds and, for each of its rows' writes,
    whether native_io wrote it."""
    from motcpp_tpu_torch.scripts import regen_golden
    from motcpp_tpu_torch.utils import native_io

    torch.set_num_threads(1)
    written, write_mot = [], native_io.write_mot

    def counted_write(*args):
        ok = write_mot(*args)
        written.append(ok)
        return ok

    native_io.write_mot = counted_write
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        regen_golden.write_set(name, "golden_long", root, "cuda")
    return time.perf_counter() - t0, written


def utilities_phase(phase, card, io_build, model, timers):
    """Phase ``phase``: what the utilities slice gives a deployment, on
    the card. (a) the nine configs through the port's reader (PyYAML or
    not) and scripts/tune.py::evaluate_params for ByteTrack over
    MOT17-mini through the auction kernel, the YAML defaults and 3
    seeded draws, equal to the same loop on the CPU; (b) the
    tests/golden_long sets of CLI_TRACKERS from scripts/regen_golden.py
    (the port's CLI), a spawned process a set (golden_long_worker), byte
    for byte through the native writer, scored by
    scripts/update_accuracy_table.py as tests/accuracy_mot17mini.json; (c) checkpoint failover
    through TrackingService in both formats at the ByteTrack flagship
    and at live BoT-SORT cadence 8; (d) one flagship and one live tick
    under utils/profiling.py::trace, and FrameTimer's p50 of phase 17's
    ticks; (e) ReIDBackend.warmup(): the unfolded forward, no kernel
    launch; (f) the native parser on both det.txt files. Returns the
    kernels' launches on (a), (c) and (d)."""
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.appearance.reid import ReIDBackend, make_embed_fn
    from motcpp_tpu_torch.config import load_tracker_config
    from motcpp_tpu_torch.data import pack_valid_rows, synth_stream_dets
    from motcpp_tpu_torch.data.mot17 import _parse_det_text
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.scripts import regen_golden, tune, update_accuracy_table
    from motcpp_tpu_torch.serving import TrackingService
    from motcpp_tpu_torch.utils import native_io

    path, build_s = io_build
    print(f"phase {phase} build: {path.name} (g++) in {build_s:.2f} s")
    # ---- (f) the native parser --------------------------------------------
    check(native_io.available(), "the native IO library did not load")
    for det in sorted(MOT_MINI.glob("*/det/det.txt")):
        got, want = native_io.parse_detections(det), _parse_det_text(det)
        check([f for f, _ in got] == [f for f, _ in want] and np.asarray(
            [r for _, r in got], np.float32).tobytes() == np.asarray(
            [r for _, r in want], np.float32).tobytes(),
            f"native and Python parsers differ on {det}")
        print(f"phase {phase} (f) native parser = Python parser on "
              f"{det.relative_to(MOT_MINI)}: {len(got)} rows identical")

    osblock_cuda.LAUNCHES = auction_cuda.LAUNCHES = 0
    # ---- (a) configs without PyYAML, scripts/tune.py's loop ---------------
    has_yaml = subprocess.run([sys.executable, "-c", "import yaml"],
                              capture_output=True).returncode == 0
    configs = {n: load_tracker_config(n) for n in TRACKER_NAMES}
    check("yaml" not in sys.modules, "the config reader imported yaml")
    cfg = configs["bytetrack"]
    check(cfg.search_space, "bytetrack.yaml has no search nodes")
    rng = np.random.default_rng(0)
    trials = [cfg.as_kwargs()] + [cfg.sample(rng) for _ in range(3)]
    scores = []
    with tempfile.TemporaryDirectory() as d:
        for i, params in enumerate(trials):
            runs = {}
            for dev in ("cuda", "cpu"):
                work = Path(d) / f"trial{i}_{dev}"
                work.mkdir()
                m = tune.evaluate_params("bytetrack", params, MOT_MINI,
                                         TUNE_FRAMES, work, device=dev,
                                         lap_impl="auction_pallas")
                check(m, f"tune trial {i}: nothing scored on {dev}")
                runs[dev] = m, {p.name: p.read_bytes()
                                for p in sorted(work.glob("*.txt"))}
            (m, texts), (m_cpu, texts_cpu) = runs["cuda"], runs["cpu"]
            check(texts == texts_cpu, f"tune trial {i}: the card's rows "
                  "differ from the CPU's")
            check(all(m[k] == m_cpu[k] for k in ("HOTA", "MOTA", "IDF1")),
                  f"tune trial {i}: the card's scores differ from the CPU's")
            scores.append(f"{'defaults' if i == 0 else f'trial {i}'} "
                          f"{params}: HOTA {m['HOTA']:.3f} MOTA "
                          f"{m['MOTA']:.3f} IDF1 {m['IDF1']:.3f}")
    tune_launches = auction_cuda.LAUNCHES
    check(tune_launches > 0, "the tune loop did not launch the auction kernel")
    print(f"phase {phase} (a) yaml importable here: {has_yaml}; nine configs "
          f"read without it ({', '.join(f'{n} {len(c.params)}' for n, c in configs.items())} "
          f"parameters); scripts/tune.py::evaluate_params for ByteTrack "
          f"through the auction kernel over MOT17-mini's "
          f"first {TUNE_FRAMES} frames, card = CPU (rows byte for byte, "
          f"HOTA, MOTA, IDF1): {' | '.join(scores)}; auction launches "
          f"{tune_launches}")

    # ---- (b) golden_long sets from the CLI on the card -----------------------
    expected = json.loads((TESTS / "accuracy_mot17mini.json").read_text())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d, ProcessPoolExecutor(
            len(CLI_TRACKERS),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = {name: pool.submit(golden_long_worker, name, d)
                for name in CLI_TRACKERS}
        walls, written = {}, []
        for name, run in runs.items():
            walls[name], writes = run.result()
            written += writes
            golden = TESTS / "golden_long" / name
            check(len(list(golden.glob("*.txt"))) == 2,
                  f"golden_long/{name} is incomplete")
            diff = regen_golden.first_difference(
                Path(d) / "golden_long" / name, golden)
            check(diff is None, f"the CLI's {name} set differs from "
                  f"tests/golden_long at {diff}")
        table = update_accuracy_table.score_table(Path(d) / "golden_long")
    for name in CLI_TRACKERS:
        got, want = table[name], expected[name]
        check(all(abs(got[k] - want[k]) <= 0.05 for k in
                  ("HOTA", "MOTA", "IDF1", "DetA", "AssA", "MOTP"))
              and all(got[k] == want[k] for k in
                      ("IDSW", "FP", "FN", "MT", "ML")),
              f"{name}'s scores differ from accuracy_mot17mini.json")
    b_s = time.perf_counter() - t0
    check(written and all(written), "rows were not written by native_io")
    print(f"phase {phase} (b) the golden_long sets of {', '.join(CLI_TRACKERS)}"
          f" from scripts/regen_golden.py (the CLI on the card, exact JV, 150 "
          f"frames of each sequence, a spawned process a set): byte for "
          f"byte, {len(written)} native writes, scores (scripts/"
          f"update_accuracy_table.py) = accuracy_mot17mini.json; "
          f"wall {b_s:.1f} s ("
          + ", ".join(f"{n} {s:.1f}" for n, s in walls.items())
          + f" s in their processes); card: {card}")

    # ---- (c) checkpoint failover through TrackingService -------------------
    osblock_cuda.LAUNCHES = auction_cuda.LAUNCHES = 0
    ticks, cut = FAILOVER_TICKS, FAILOVER_TICKS // 2
    dets, masks, _ = pack_valid_rows(*synth_stream_dets(
        np.random.default_rng(0), ticks + 1, S, N, n_obj=N_OBJ))
    counts = masks.sum(-1)

    def make_flagship():
        svc = TrackingService.from_tracker(
            "bytetrack", S, max_dets=N, device="cuda",
            tracker_kw=dict(max_tracks=K, lap_impl="auction_pallas"))
        svc.handles = [svc.attach() for _ in range(S)]
        return svc

    def submit(svc, t):
        for s, h in enumerate(svc.handles):
            svc.submit(h, dets[t, s, :counts[t, s]])

    with tempfile.TemporaryDirectory() as d:
        flag = failover("ByteTrack flagship", make_flagship, submit, ticks,
                        cut, Path(d), card)
    flag_launches = auction_cuda.LAUNCHES
    check(flag_launches == 2 * (ticks + cut + 2 * (ticks - cut)),
          f"flagship failover: {flag_launches} auction launches")

    live_ticks = 2 * CADENCE
    ldets, lmasks, order = pack_valid_rows(*synth_stream_dets(
        np.random.default_rng(0), live_ticks + 1, LIVE_S, LIVE_N,
        n_obj=LIVE_OBJ))
    lcounts = lmasks.sum(-1)
    crops_host = torch.randint(0, 256, (LIVE_S, LIVE_N, *CROP_HW, 3),
                               dtype=torch.uint8, device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(0)).cpu().numpy()
    embed = make_embed_fn(model, compute_dtype="bfloat16", fused=True,
                          device="cuda")

    def make_live():
        svc = TrackingService.from_tracker(
            "botsort", LIVE_S, max_dets=LIVE_N, emb_dim=LIVE_D,
            device="cuda", crop_hw=CROP_HW, embed_fn=embed,
            emb_cadence=CADENCE, tracker_kw=dict(
                with_reid=True, max_tracks=LIVE_K,
                lap_impl="auction_pallas"))
        svc.handles = [svc.attach() for _ in range(LIVE_S)]
        return svc

    def submit_live(svc, t):
        for s, h in enumerate(svc.handles):
            n = lcounts[t, s]
            svc.submit(h, ldets[t, s, :n], crops=crops_host[
                (s - t) % LIVE_S][order[t, s, :n]])

    osblock_cuda.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as d:
        live = failover(f"BoT-SORT live cadence {CADENCE}", make_live,
                        submit_live, live_ticks, CADENCE, Path(d), card)
    live_ticks_run = live_ticks + CADENCE + 2 * (live_ticks - CADENCE)
    check(osblock_cuda.LAUNCHES == 6 * live_ticks_run
          and auction_cuda.LAUNCHES - flag_launches == 2 * live_ticks_run,
          f"live failover: {osblock_cuda.LAUNCHES} OSBlock and "
          f"{auction_cuda.LAUNCHES - flag_launches} auction launches")
    auction_launches = tune_launches + auction_cuda.LAUNCHES
    osblock_launches = osblock_cuda.LAUNCHES

    # ---- (d) profiling -------------------------------------------------------
    osblock_cuda.LAUNCHES = auction_cuda.LAUNCHES = 0
    svc = flag["npz"]
    names = traced_kernels(lambda: (submit(svc, ticks), svc.step()))
    check(any("auction_kernel" in n for n in names),
          "the flagship tick's trace names no auction kernel")
    svc = live["pt"]
    live_names = traced_kernels(lambda: (submit_live(svc, live_ticks),
                                         svc.step()))
    check(any("auction_kernel" in n for n in live_names)
          and any("osblock_kernel" in n for n in live_names),
          "the live tick's trace names no auction or no OSBlock kernel")
    auction_launches += auction_cuda.LAUNCHES
    osblock_launches += osblock_cuda.LAUNCHES
    timed = "; ".join(
        f"{name} FrameTimer p50 {rep['p50_ms']:.3f} ms (mean "
        f"{rep['mean_ms']:.3f}, p95 {rep['p95_ms']:.3f}, {rep['frames']} "
        f"ticks, {rep['streams_at_30fps']:.1f} streams at 30 FPS) beside "
        f"phase 17's median {median * 1e3:.3f} ms"
        for name, (rep, median) in timers.items())
    def ours(found):
        return sorted(n for n in found
                      if "auction_kernel" in n or "osblock_kernel" in n)

    print(f"phase {phase} (d) trace(): the flagship tick's trace names "
          f"{ours(names)}, the live tick's {ours(live_names)}; {timed}")
    del flag, live, svc, crops_host

    # ---- (e) the ReID warm-up ------------------------------------------------
    # ReIDBackend runs the unfolded OSNet, as the JAX backend runs its Flax
    # module: its warm-up launches neither kernel. Its batch is embedded on
    # the card (TF32 off) as on the CPU.
    osblock_cuda.LAUNCHES = auction_cuda.LAUNCHES = 0
    feats = {}
    backends = {"cuda": ReIDBackend(device="cuda"),
                "cpu": ReIDBackend(device="cpu")}
    for key, b in backends.items():
        inner = b.get_features
        b.get_features = lambda x, i, inner=inner, key=key: feats.setdefault(
            key, inner(x, i))
    t0 = time.perf_counter()
    with exact_float32():
        backends["cuda"].warmup()
        torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    check(osblock_cuda.LAUNCHES == 0 and auction_cuda.LAUNCHES == 0,
          f"warmup() launched the OSBlock kernel {osblock_cuda.LAUNCHES} and "
          f"the auction kernel {auction_cuda.LAUNCHES} times, not 0")
    backends["cpu"].warmup()
    warm_err = float(np.abs(feats["cuda"] - feats["cpu"]).max())
    check(feats["cuda"].shape == (2, 512) and warm_err <= 1e-3,
          f"warmup()'s embeddings: shape {feats['cuda'].shape}, "
          f"max |card - cpu| {warm_err:.3g} > 1e-3")
    print(f"phase {phase} (e) ReIDBackend(osnet_x1_0 f32, TF32 off)"
          f".warmup(): the unfolded forward, 0 kernel launches, "
          f"{warm_ms:.1f} ms (first "
          f"call), embeddings max |card - cpu| {warm_err:.3g} <= 1e-3")
    return {"auction_launches": auction_launches,
            "osblock_launches": osblock_launches}


SHARDS = 2  # phase 19's shards, all on the one card
SHARDED_REPEATS = 3  # timed runs of phase 19's paths, after one warm-up


def first_difference(go, gm, wo, wm, id_col):
    """(frame, stream) of the first emission mask or id that differs
    between two rollouts' (T, S, K, C) outputs and (T, S, K) masks, the
    ids in column ``id_col``; None where none differs."""
    differs = (gm != wm) | (gm & wm & (go[..., id_col] != wo[..., id_col]))
    where = differs.any(-1).nonzero()
    return None if not len(where) else tuple(int(i) for i in where[0])


def same_outputs(label, got, want, atol=0.0, boxes=slice(0, 4), id_col=4):
    """Two rollouts' (outputs, masks), ``got`` moved to ``want``'s device:
    identical masks and ids (column ``id_col``; the first differing
    (frame, stream) named otherwise), and the emitted rows bit for bit,
    or with ``atol`` the ``boxes`` columns within it. Returns the
    emissions and the largest box difference."""
    (go, gm), (wo, wm) = (tuple(t.to(want[0].device) for t in got), want)
    where = first_difference(go, gm, wo, wm, id_col)
    check(where is None, f"{label}: masks or ids differ, first at (frame, "
          f"stream) {where}")
    emitted = int(gm.sum())
    check(emitted > 0, f"{label}: no emissions")
    if not atol:
        check(same_bits(go[gm], wo[wm]), f"{label}: emitted boxes differ")
        return emitted, 0.0
    err = float((go[gm][:, boxes] - wo[wm][:, boxes]).abs().max())
    check(err <= atol, f"{label}: boxes differ by {err:.2e} (> {atol})")
    return emitted, err


def failover_across(label, make_one, make_sharded, submit, ticks, cut, work,
                    card):
    """The uninterrupted one-device run of ``ticks`` ticks against a run
    cut after ``cut`` ticks whose state crosses layouts through a file:
    sharded -> .npz -> one device, and one device -> torch file ->
    sharded; each continuation must equal the uninterrupted run bit for
    bit."""
    from motcpp_tpu_torch.utils.checkpoint import load_state, save_state

    want = run_service(make_one(), submit, range(ticks))
    report = []
    for fmt, first_make, then_make, way in (
            ("npz", make_sharded, make_one, "sharded -> one device"),
            ("pt", make_one, make_sharded, "one device -> sharded")):
        first = first_make()
        run_service(first, submit, range(cut))
        path = work / f"{label.replace(' ', '_')}.{fmt}"
        save_state(first.states, path)
        svc = then_make()
        svc.restore(load_state(svc._init_states(), path))
        got = run_service(svc, submit, range(cut, ticks))
        check(same_emissions(got, want[cut:]), f"{label}: {way} through "
              f"{fmt} differs from the uninterrupted run")
        report.append(f"{way} through {fmt} "
                      f"({path.stat().st_size / 1e6:.1f} MB)")
    emitted = sum(int(b.out_masks.sum()) for b in want[cut:])
    print(f"phase 19 (e) {label}: {ticks} ticks uninterrupted on one device "
          f"= {cut} ticks, checkpoint, {ticks - cut} ticks, "
          f"{'; '.join(report)}: bit for bit ({emitted} emissions after the "
          f"cut); card: {card}")


def sharded_phase(phase, card, byte, live, hybrid, served_live, scene):
    """Phase ``phase``: streams sharded over devices, SHARDS shards on the
    one card (``devices=["cuda"] * SHARDS``). (a) the ByteTrack flagship
    (phase 3's frames) through the sharded runner: phase 3's masks, ids
    and boxes bit for bit, the auction kernel against its plain version on
    each shard's own stage-1 and stage 2+3 inputs, ms per frame-batch
    beside phase 3's; (b) emission_stats and per_stream_emissions over
    (a)'s masks as shards equal plain reductions of phase 3's masks; (c)
    live BoT-SORT at cadence 8 (phase 7's shape) through the runner and
    through TrackingService with the compacted crops: phase 7's and phase
    17's emissions; (d) live HybridSORT at a priority budget: at S*N (the
    budget covers every shard) the one-device run, and at its deployed
    0.8 each shard embeds exactly its half of the budget, timed beside
    phase 14; (e) the flagship service's checkpoint across layouts; (f)
    the two-process dryrun over gloo. Returns the kernels' launches on the
    sharded paths and each kernel's largest difference from its plain
    version on a shard's inputs."""
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.appearance.reid import make_embed_fn
    from motcpp_tpu_torch.data import pack_valid_rows, synth_stream_dets
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.parallel import (
        Mesh,
        MultiStreamRunner,
        emission_stats,
        per_stream_emissions,
        shard_over_streams,
    )
    from motcpp_tpu_torch.parallel.multihost import dryrun_multihost
    from motcpp_tpu_torch.serving import TrackingService

    t_phase = time.perf_counter()
    devices = ["cuda"] * SHARDS
    mesh = Mesh(devices)
    counters = (osblock_cuda, auction_cuda)
    launches = {m: 0 for m in counters}

    # ---- (a) the ByteTrack flagship over the shards ------------------------
    dets, masks = byte["inputs"]
    init, step = scoreboard("bytetrack")("auction_pallas")
    runner = MultiStreamRunner(init, step, S, devices=devices)
    for m in counters:
        m.LAUNCHES = 0
    run_s, times, _, (outs, out_masks) = timed_runs(
        runner, dets, masks, counters,
        {auction_cuda: 2 * SHARDS * T, osblock_cuda: 0}, "sharded ByteTrack",
        SHARDED_REPEATS)
    ms = run_s * 1e3 / T
    for m in counters:
        launches[m] += m.LAUNCHES
    emitted, _ = same_outputs("sharded ByteTrack", (outs, out_masks),
                              byte["outputs"])
    print(f"phase {phase} (a) ByteTrack S={S} over {SHARDS} shards on one "
          f"card, T={T}: {ms:.3f} ms per frame-batch (median of "
          f"{SHARDED_REPEATS}, runs {[round(t * 1e3, 1) for t in times]} ms)"
          f" beside phase 3's one device {byte['frame_ms']:.3f} ms "
          f"({ms / byte['frame_ms']:.2f}x); masks, ids and boxes = phase 3's "
          f"bit for bit ({emitted} emissions); {2 * SHARDS} auction launches"
          f" a frame; card: {card}")
    runner.reset()
    runner.run(dets[: T // 2], masks[: T // 2])
    stages = [f"shard {i} {name}" for i in range(SHARDS)
              for name in ("stage 1", "stages 2+3")]
    stats = auction_on_path(
        phase, "sharded ByteTrack", stages,
        lambda: runner.run(dets[T // 2: T // 2 + 1],
                           masks[T // 2: T // 2 + 1]), card)
    del runner

    # ---- (b) the collectives over (a)'s masks ----------------------------
    chunks = shard_over_streams(mesh, out_masks)
    got = emission_stats(chunks, mesh)
    om = byte["outputs"][1]
    want = {"total_emissions": int(om.sum()), "frames_processed": T * S,
            "active_streams": int(om.any(2).any(0).sum()),
            "peak_tracks_per_frame": int(om.sum(2).max())}
    per = per_stream_emissions(chunks, mesh)
    check(got == want and emission_stats(out_masks, mesh) == want,
          f"emission_stats {got} != the plain reductions {want}")
    check(torch.equal(per, om.sum((0, 2), dtype=torch.int32)),
          "per_stream_emissions differs from the plain reduction")
    print(f"phase {phase} (b) emission_stats over {SHARDS} shards = plain "
          f"reductions of phase 3's masks: {got}; per_stream_emissions = "
          f"the plain per-stream sums (min {int(per.min())}, max "
          f"{int(per.max())})")
    del outs, out_masks, chunks

    # ---- (c) live BoT-SORT at cadence 8: runner and service ---------------
    dets_all, masks_all, crops_all = scene
    legs = (dets_all[:LIVE_T], masks_all[:LIVE_T], crops_all[:LIVE_T])
    embed = served_live["embed"]
    runner = MultiStreamRunner(*live["make"], LIVE_S, devices=devices,
                               embed_fn=embed, emb_cadence=CADENCE)
    for m in counters:
        m.LAUNCHES = 0
    live_s, times, _, got = timed_runs(
        runner, *legs[:2], counters, {osblock_cuda: 6 * SHARDS * LIVE_T,
                                      auction_cuda: 2 * SHARDS * LIVE_T},
        "sharded BoT-SORT live", SHARDED_REPEATS, embs=legs[2])
    live_ms = live_s * 1e3 / LIVE_T
    emitted, _ = same_outputs("sharded BoT-SORT live cadence 8", got,
                              live["outputs"]["cadence 8"])
    ticks = served_live["ticks"]
    svc = TrackingService.from_tracker(
        "botsort", LIVE_S, max_dets=LIVE_N, emb_dim=LIVE_D, devices=devices,
        crop_hw=CROP_HW, embed_fn=embed, emb_cadence=CADENCE,
        tracker_kw=dict(with_reid=True, max_tracks=LIVE_K,
                        lap_impl="auction_pallas"))
    check(svc._cad_compact, "the sharded service's cadence_compact is off")
    hs = [svc.attach() for _ in range(LIVE_S)]
    batches = []
    for t in range(ticks):
        served_live["submit_to"](svc, hs, t)
        batches.append(svc.step())
    for m in counters:
        launches[m] += m.LAUNCHES
    per_frame = 6 * SHARDS * (LIVE_T * (1 + SHARDED_REPEATS) + ticks)
    check(osblock_cuda.LAUNCHES == per_frame,
          f"sharded live: {osblock_cuda.LAUNCHES} OSBlock launches, want "
          f"{per_frame} (6 a shard an embedded frame)")
    check(same_emissions(batches, served_live["batches"]),
          "the sharded service differs from phase 17's one-device service")
    print(f"phase {phase} (c) BoT-SORT live ReID cadence {CADENCE}, S={LIVE_S}"
          f" over {SHARDS} shards ({LIVE_S // SHARDS} streams, "
          f"{LIVE_S // SHARDS // CADENCE * LIVE_N} crops a shard a frame): "
          f"runner {live_ms:.3f} ms per frame-batch (runs "
          f"{[round(t * 1e3, 1) for t in times]} ms) beside phase 7's "
          f"{live['frame_ms']['cadence 8']:.3f} ms, emissions = phase 7's "
          f"bit for bit ({emitted}); TrackingService over the shards with "
          f"compacted crops, {ticks} ticks = phase 17's service bit for bit "
          f"({sum(int(b.out_masks.sum()) for b in batches)} emissions); 6 "
          f"OSBlock and 2 auction launches a shard a frame; card: {card}")
    runner.reset()  # the kernel on each shard's 64-stream crops
    blocks = [osblock_on_path(phase, runner, *legs, shards=SHARDS)]
    del runner, svc, batches

    # ---- (d) HybridSORT live at a priority budget -------------------------
    def make():
        return scoreboard("hybridsort", live=True)("auction_pallas")

    model_embed = make_embed_fn(live["model"], compute_dtype="bfloat16",
                                fused=True, device="cuda")
    batch_sizes = []

    def sized_embed(crops):
        batch_sizes.append(crops.shape[0])
        return model_embed(crops)

    full = LIVE_S * LIVE_N
    for m in counters:
        m.LAUNCHES = 0
    got = {}
    for n_dev in (None, SHARDS):
        kw = ({"device": "cuda"} if n_dev is None else {"devices": devices})
        got[n_dev] = MultiStreamRunner(
            *make(), LIVE_S, embed_fn=sized_embed, crop_budget=full,
            emb_priority=True, **kw).run(*legs[:2], embs=legs[2])
    emitted, _ = same_outputs(f"sharded HybridSORT live at budget {full}",
                              got[SHARDS], got[None])
    budget = round(HYBRID_PRIORITY * LIVE_S * LIVE_N)
    runner = MultiStreamRunner(*make(), LIVE_S, devices=devices,
                               embed_fn=sized_embed, crop_budget=budget,
                               emb_priority=True)
    batch_sizes.clear()
    hybrid_s, times, *_ = timed_runs(
        runner, *legs[:2], counters, {osblock_cuda: 6 * SHARDS * LIVE_T,
                                      auction_cuda: 3 * SHARDS * LIVE_T},
        "sharded HybridSORT live", SHARDED_REPEATS, embs=legs[2])
    hybrid_ms = hybrid_s * 1e3 / LIVE_T
    for m in counters:
        launches[m] += m.LAUNCHES
    check(batch_sizes == [budget // SHARDS] * (SHARDS * LIVE_T
                                                * (1 + SHARDED_REPEATS)),
          f"sharded HybridSORT embedded batches of {sorted(set(batch_sizes))}"
          f" crops, want {budget // SHARDS}")
    runner.reset()  # the kernel on each shard's share of the budget
    blocks.append(osblock_on_path(phase, runner, *legs, shards=SHARDS))
    label = f"priority {HYBRID_PRIORITY}"
    print(f"phase {phase} (d) HybridSORT live ReID over {SHARDS} shards: at "
          f"budget S*N={full} = one device bit for bit ({emitted} "
          f"emissions); at {label} (budget {budget}) each shard embeds "
          f"exactly {budget // SHARDS} crops a frame, {hybrid_ms:.3f} ms per "
          f"frame-batch (runs {[round(t * 1e3, 1) for t in times]} ms) "
          f"beside phase 14's one device {hybrid['frame_ms'][label]:.3f} ms;"
          f" card: {card}")
    del runner, got

    # ---- (e) the flagship's checkpoint across layouts ----------------------
    ticks, cut = FAILOVER_TICKS, FAILOVER_TICKS // 2
    fdets, fmasks, _ = pack_valid_rows(*synth_stream_dets(
        np.random.default_rng(0), ticks + 1, S, N, n_obj=N_OBJ))
    counts = fmasks.sum(-1)

    def flagship(n_dev):
        def make_svc():
            svc = TrackingService.from_tracker(
                "bytetrack", S, max_dets=N,
                **({"device": "cuda"} if n_dev is None
                   else {"devices": devices}),
                tracker_kw=dict(max_tracks=K, lap_impl="auction_pallas"))
            svc.handles = [svc.attach() for _ in range(S)]
            return svc
        return make_svc

    def submit(svc, t):
        for s, h in enumerate(svc.handles):
            svc.submit(h, fdets[t, s, :counts[t, s]])

    for m in counters:
        m.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as d:
        failover_across("ByteTrack flagship", flagship(None),
                        flagship(SHARDS), submit, ticks, cut, Path(d), card)
    for m in counters:
        launches[m] += m.LAUNCHES

    # ---- (f) the two-process dryrun over gloo ------------------------------
    report = dryrun_multihost(2, device="cuda")
    print(f"phase {phase} (f) dryrun_multihost: {report['processes']} "
          f"processes x {report['devices_per_process']} shards on "
          f"{report['device']}, S={report['streams']}, counts over gloo = one"
          f" process's ({report['emissions']} emissions), "
          f"{report['seconds']:.1f} s; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s; card: {card}")
    return {"auction_launches": launches[auction_cuda],
            "osblock_launches": launches[osblock_cuda],
            "auction_err": stats["auction_err"],
            "osblock_err": max(b["max_err"] for b in blocks)}


def profile_split(run, parts, patches=(), frames=None, rest="the rest"):
    """utils/profiling.py's device_split of ``run(*parts[1])`` after the
    warm-up ``run(*parts[0])`` (a path's consecutive frames, so that the
    profiled ones continue its state, or one call twice), with each
    (module, attribute, label) of ``patches`` wrapped in a
    record_function range. Returns the split and its line: the kernels'
    count and device time, the wall under the profiler, the device's
    busy share, and each label's time and share, the kernels that start
    inside one of its ranges' device spans (the rest under ``rest``);
    a frame over ``frames`` frames where given. Fails where a label's
    ranges hold no device time."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, label in patches:
        setattr(mod, attr, ranged(getattr(mod, attr), label))
    it = iter(parts)
    try:
        split = device_split(lambda: run(*next(it)),
                             [label for _, _, label in patches])
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)
    n, unit = (frames, " a frame") if frames else (1, "")
    device_ms, wall_ms = split["device_ms"], split["wall_ms"]
    line = [f"{split['kernels'] / n:.0f} kernels{unit}, device "
            f"{device_ms / n:.3f} ms{unit} in {wall_ms / n:.3f} ms of wall "
            f"under the profiler (busy {100 * device_ms / wall_ms:.1f}%)"]
    inside = 0.0
    for label, ms in split["labels"].items():
        check(ms, f"the profiler saw no device time inside {label}")
        inside += ms
        line.append(f"{label} {ms / n:.3f} ms{unit} "
                    f"({100 * ms / device_ms:.1f}%)")
    if patches:
        line.append(f"{rest} {(device_ms - inside) / n:.3f} ms{unit} "
                    f"({100 * (device_ms - inside) / device_ms:.1f}%)")
    return split, "; ".join(line)


def fixture_cosines():
    """Per-crop cosine of the int8 embed (bf16 and float32 activations)
    to the float32 embed (TF32 off) at the trained osnet_x0_25 of
    tests/fixtures, on the crops of MOT17-02's first frame's detections
    (256x128, uint8 BGR); "not measured" where no image reader (cv2 or
    PIL) is installed."""
    from motcpp_tpu_torch.appearance import quant
    from motcpp_tpu_torch.appearance.osnet import load_weights_auto
    from motcpp_tpu_torch.appearance.reid import extract_crops, make_embed_fn
    from motcpp_tpu_torch.data import MOT17Dataset
    from motcpp_tpu_torch.data.mot17 import imread

    seq = MOT_MINI / "MOT17-02-FRCNN"
    img = imread(seq / "img1" / "000001.jpg")
    if img is None:
        return ("int8 cosine at the trained fixture on MOT17-02 crops: not "
                "measured (no cv2 or PIL to read the frame)")
    boxes = MOT17Dataset.load_detections(seq / "det" / "det.txt")[1][:, :4]
    # extract_crops' sampling, unnormalized: RGB in [0, 255], then BGR uint8
    crops = extract_crops(torch.as_tensor(img, device="cuda"),
                          torch.as_tensor(boxes, device="cuda"), CROP_HW,
                          ((0.0, 0.0, 0.0), (1 / 255,) * 3))
    crops = crops.round().clamp(0, 255).flip(-1).to(torch.uint8)
    model = load_weights_auto(TESTS / "fixtures" / "osnet_x0_25_converted.npz")
    with exact_float32():
        ref = make_embed_fn(model, device="cuda")(crops)
        cos = {act: crop_cosine(quant.make_embed_fn_int8(
            model, act_dtype=act, device="cuda")(crops), ref)
            for act in ("bfloat16", "float32")}
    return (f"int8 cosine to float32 at the trained fixture "
            f"(osnet_x0_25) on MOT17-02 frame 1's {crops.shape[0]} crops: "
            + ", ".join(f"{act} activations min {float(c.min()):.4f} median "
                        f"{float(c.median()):.4f}" for act, c in cos.items()))


def int8_phase(phase, card, live, served_live, scene):
    """Phase ``phase``: int8 and dense-lite ReID at bench.py::
    bench_livereid's widths (osnet_x1_0, D=512, the seeded weights of
    phase 7, 256x128 uint8 crops, phase 7's scene): (a) quantize_osnet on
    the host, timed, and the int8 and float weight bytes that
    make_embed_fn_int8 puts on the card; (b) the int8 embed of 256 crops
    (a cadence-8 frame) and 2048 (every frame) through torch._int_mm
    against the same embed through the plain int8 product (bit for bit),
    its device ms beside the bf16 fused and bf16 folded embeds of the
    same crops, the card's embed of HOST_INT8_CROPS crops against the
    host's int8 forward (per-crop cosine at least HOST_INT8_COS), a
    profile of one 256-crop embed split among the int8 products,
    quantize, dequantize and the depthwise convs, and the
    per-crop cosine to the bf16 fused embeddings; (c) live BoT-SORT at
    cadence 8 with the int8 embed through MultiStreamRunner (one warm-up
    and REPEATS timed runs, two auction launches a frame, no OSBlock
    launch), the auction kernel against its plain version on the path's
    own inputs, and the share of emissions equal to phase 7's bf16 path;
    (d) the same through TrackingService (phase 17's packed frames and
    crops through the mux), equal to the runner on the same frames bit
    for bit; (e) dense-lite: compose_lite_dense + _forward_folded_dense
    against forward_folded_f32 on 256 crops with TF32 off, errors and
    each forward's ms. Returns the launches of (c) and (d)."""
    from torch.profiler import record_function

    from motcpp_tpu_torch.appearance import osblock_cuda, quant
    from motcpp_tpu_torch.appearance.reid import make_embed_fn
    from motcpp_tpu_torch.ops import auction_cuda, int8
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
    from motcpp_tpu_torch.serving import TrackingService

    t_phase = time.perf_counter()
    model = live["model"]
    # ---- (a) quantize on the host; the bytes on the card ------------------
    t0 = time.perf_counter()
    qvars = quant.quantize_osnet(model)
    quantize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    embed = quant.make_embed_fn_int8(model, device="cuda")
    make_s = time.perf_counter() - t0
    on_card = quant._on_device(qvars, torch.device("cuda"))
    tensors = ([t for leaf in on_card["q"].values() for t in leaf.values()
                if isinstance(t, torch.Tensor)]
               + [t for leaf in on_card["folded"].values()
                  for t in leaf.values() if t.device.type == "cuda"]
               + list(on_card["act"].values()))
    int8_bytes = sum(t.numel() for t in tensors if t.dtype == torch.int8)
    float_bytes = sum(t.numel() * t.element_size() for t in tensors
                      if t.dtype != torch.int8)
    model_bytes = sum(p.numel() * 4 for p in model.parameters())
    del on_card, tensors
    print(f"phase {phase} (a) quantize_osnet(osnet_x1_0) on the host: "
          f"{quantize_s:.2f} s ({len(qvars['act'])} input scales from "
          f"{quant.CALIB_SHAPE} calibration crops); make_embed_fn_int8 "
          f"(quantize and copy) {make_s:.2f} s; on the card: int8 weights "
          f"{int8_bytes / 1e6:.3f} MB, float (scales, biases, depthwise, "
          f"gates) {float_bytes / 1e6:.3f} MB, against the float32 model's "
          f"{model_bytes / 1e6:.3f} MB; card: {card}")

    # ---- (b) the int8 embed against its plain version; times; profile -----
    dets_all, masks_all, crops_all = scene
    flat = crops_all[0].reshape(-1, *CROP_HW, 3)
    per_cadence = -(-LIVE_S // CADENCE) * LIVE_N
    fused = make_embed_fn(model, compute_dtype="bfloat16", fused=True,
                          device="cuda")
    folded = make_embed_fn(model, compute_dtype="bfloat16", folded=True,
                           device="cuda")
    launch = int8.int8_matmul
    per_embed = {}
    for B in (per_cadence, flat.shape[0]):
        x = flat[:B]
        before = int8.LAUNCHES
        got = embed(x)
        torch.cuda.synchronize()
        per_embed[B] = int8.LAUNCHES - before
        check(per_embed[B] > 0, f"the int8 embed of {B} crops launched no "
              "int8 product")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        int8.int8_matmul = int8.int8_matmul_reference
        try:  # one call: the plain products take the device seconds
            start.record()
            want = embed(x)
            end.record()
            torch.cuda.synchronize()
        finally:
            int8.int8_matmul = launch
        plain_ms = start.elapsed_time(end)
        check(torch.equal(got, want), f"int8 embed of {B} crops: torch._int_mm"
              f" and the plain int8 product differ by "
              f"{float((got - want).abs().max()):.3g}")
        check(bool(torch.isfinite(got).all())
              and bool(((got.norm(dim=1) - 1).abs() < 1e-3).all()),
              f"int8 embed of {B} crops: not finite unit-norm rows")
        reps = 5 if B <= per_cadence else 1
        ms = {label: call_ms(lambda fn=fn: fn(x), reps)[0] for label, fn in (
            ("int8", embed), ("bf16 fused", fused), ("bf16 folded", folded))}
        cos = crop_cosine(got, fused(x))
        print(f"phase {phase} (b) int8 embed of {B} crops: torch._int_mm = "
              f"plain int8 product bit for bit ({per_embed[B]} products); "
              f"device ms int8 {ms['int8']:.3f}, bf16 fused "
              f"{ms['bf16 fused']:.3f}, bf16 folded {ms['bf16 folded']:.3f}, "
              f"int8 through the plain product {plain_ms:.3f} (one call); "
              f"per-crop "
              f"cosine to the bf16 fused embeddings min "
              f"{float(cos.min()):.4f}, median {float(cos.median()):.4f}; "
              f"card: {card}")
    # the card's embed against the port's int8 forward on the host, both
    # in bf16 (tests/test_torch_quant.py holds the host's against the JAX
    # package's bf16 forward): sums in another order may flip a quantized
    # activation by one step, hence a cosine bar and not equality
    x = flat[:HOST_INT8_CROPS]
    t0 = time.perf_counter()
    host = quant.make_embed_fn_int8(model, act_dtype="bfloat16",
                                    device="cpu")(x.cpu())
    host_s = time.perf_counter() - t0
    got = embed(x).cpu()
    cos = crop_cosine(got, host)
    check(bool((cos >= HOST_INT8_COS).all()),
          f"int8 embed on the card vs the host's bf16 int8 forward: per-crop "
          f"cosine min {float(cos.min()):.6f} < {HOST_INT8_COS}")
    print(f"phase {phase} (b) int8 embed of {HOST_INT8_CROPS} crops on the "
          f"card vs the host's int8 forward (bf16 activations both, "
          f"{host_s:.1f} s on the host): per-crop cosine min "
          f"{float(cos.min()):.6f} (bar {HOST_INT8_COS}), max abs err "
          f"{float((got - host).abs().max()):.3g}")
    print(f"phase {phase} (b) {fixture_cosines()}")
    x = flat[:per_cadence]
    _, split = profile_split(embed, [(x,), (x,)], [
        (int8, "int8_matmul", "int8 products"),
        (quant, "_quantize_act", "quantize"),
        (quant, "_dequantize", "dequantize"),
        (quant, "_conv", "depthwise")],
        rest="the rest (preprocessing, gates, pools, residuals, norm)")
    print(f"phase {phase} (b) profile of one int8 embed of {per_cadence} "
          f"crops: {split}")
    del fused, folded, got, want

    # ---- (c) live BoT-SORT at cadence 8 through the runner ----------------
    last = []

    def embed_fn(crops):
        with record_function("osnet"):
            e = embed(crops)
        last[:] = [e]
        return e

    init, step = live["make"]
    dets, masks, crops = (dets_all[:LIVE_T], masks_all[:LIVE_T],
                          crops_all[:LIVE_T])
    counters = (osblock_cuda, auction_cuda, int8)
    want = {osblock_cuda: 0, auction_cuda: 2 * LIVE_T,
            int8: per_embed[per_cadence] * LIVE_T}
    for m in counters:
        m.LAUNCHES = 0
    runner = MultiStreamRunner(init, step, LIVE_S, device="cuda",
                               embed_fn=embed_fn, emb_cadence=CADENCE)
    run_s, times, _, (outs, out_masks) = timed_runs(
        runner, dets, masks, counters, want, "BoT-SORT int8 live", REPEATS,
        embs=crops)
    launches = {m: m.LAUNCHES for m in counters}
    emitted = check_live_outputs("BoT-SORT int8 live", last[0], outs,
                                 out_masks)
    bo, bm = live["outputs"]["cadence 8"]
    same = out_masks & bm & (outs[..., 4] == bo[..., 4]) & (
        (outs[..., :4] - bo[..., :4]).abs().amax(-1) <= 1e-3)
    share = int(same.sum()) / max(int(out_masks.sum()), int(bm.sum()), 1)
    frame_ms = run_s * 1e3 / LIVE_T
    print(f"phase {phase} (c) live ReID int8 cadence {CADENCE}: S={LIVE_S} "
          f"N={LIVE_N} K={LIVE_K} D={LIVE_D} osnet_x1_0 int8 (bf16 "
          f"activations to the first gate, float32 after) "
          f"{CROP_HW[0]}x{CROP_HW[1]} T={LIVE_T}: "
          f"{frame_ms:.3f} ms per frame-batch (median of {REPEATS}, runs "
          f"{[round(t * 1e3, 1) for t in times]} ms), "
          f"{LIVE_S * LIVE_T / run_s / 30:.2f} streams at 30 FPS, "
          f"{per_cadence * LIVE_T / run_s:.0f} crops/s ({per_cadence} per "
          f"frame), {emitted} emissions in the last run; phase 7's bf16 "
          f"fused row {live['frame_ms']['cadence 8']:.3f} ms; "
          f"{100 * share:.2f}% of emissions equal phase 7's ({int(bm.sum())}"
          f" there); launches per run: int8 products "
          f"{want[int8]}, auction {want[auction_cuda]}, OSBlock 0; card: "
          f"{card}")
    runner = MultiStreamRunner(init, step, LIVE_S, device="cuda",
                               embed_fn=embed, emb_cadence=CADENCE)
    runner.run(dets[:2], masks[:2], embs=crops[:2])
    auction_stats = auction_on_path(
        phase, "BoT-SORT int8 live", ("stage 1", "stages 2+3"),
        lambda: runner.run(dets[2:3], masks[2:3], embs=crops[2:3]), card)
    del runner, last

    # ---- (d) the same through TrackingService ------------------------------
    ticks = served_live["ticks"]
    fdets, fmasks, order, crops_host = served_live["frames"]
    svc = TrackingService.from_tracker(
        "botsort", LIVE_S, max_dets=LIVE_N, emb_dim=LIVE_D, device="cuda",
        crop_hw=CROP_HW, embed_fn=embed, emb_cadence=CADENCE,
        tracker_kw=dict(with_reid=True, max_tracks=LIVE_K,
                        lap_impl="auction_pallas"))
    check(svc._cad_compact, "the int8 service's cadence_compact is off")
    hs = [svc.attach() for _ in range(LIVE_S)]
    for m in counters:
        m.LAUNCHES = 0
    batches = []
    for t in range(ticks):
        served_live["submit_to"](svc, hs, t)
        batches.append(svc.step())
    check(osblock_cuda.LAUNCHES == 0 and auction_cuda.LAUNCHES == 2 * ticks
          and int8.LAUNCHES == per_embed[per_cadence] * ticks,
          f"int8 service: launches OSBlock {osblock_cuda.LAUNCHES}, auction "
          f"{auction_cuda.LAUNCHES}, int8 {int8.LAUNCHES} over {ticks} ticks")
    for m in counters:
        launches[m] += m.LAUNCHES
    del svc
    crops0 = torch.from_numpy(crops_host).cuda()
    runner = MultiStreamRunner(init, step, LIVE_S, device="cuda",
                               embed_fn=embed, emb_cadence=CADENCE)
    ar = torch.arange(LIVE_S, device="cuda")[:, None]
    parts = []
    for t in range(ticks):
        crops_t = torch.roll(crops0, t, 0)[ar, torch.from_numpy(order[t])
                                           .cuda()]
        parts.append(runner.run(fdets[t:t + 1], fmasks[t:t + 1],
                                embs=crops_t[None]))
    served = [torch.cat([p[i] for p in parts]) for i in range(2)]
    emitted, _ = check_served("BoT-SORT int8 serving", batches, *served,
                              atol=0.0)
    print(f"phase {phase} (d) TrackingService with the int8 embed, "
          f"cadence {CADENCE}, {ticks} ticks of phase 17's frames and crops "
          f"through the mux = the runner on the same frames bit for bit "
          f"({emitted} emissions); launches a tick: int8 products "
          f"{per_embed[per_cadence]}, auction 2, OSBlock 0; card: {card}")
    del runner, parts, served, batches, crops0

    # ---- (e) dense-lite against the folded forward, TF32 off --------------
    from motcpp_tpu_torch.appearance.reid import IMAGENET_MEAN, IMAGENET_STD

    with exact_float32():
        tree = {n: {k: v.cuda() for k, v in leaf.items()}
                for n, leaf in qvars["folded"].items()}
        composed = quant.compose_lite_dense(tree)
        mean = torch.tensor(IMAGENET_MEAN, device="cuda")
        std = torch.tensor(IMAGENET_STD, device="cuda")
        xf = (flat[:per_cadence].float().flip(-1) / 255.0 - mean) / std
        dense = quant._forward_folded_dense(composed, xf)
        ref = quant.forward_folded_f32(tree, xf)
        err = float((dense - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(bool(torch.isfinite(dense).all()) and rel <= 1e-4,
              f"dense-lite vs folded float32: relative error {rel:.2e} > 1e-4")
        dense_ms = call_ms(lambda: quant._forward_folded_dense(composed, xf),
                           2)[0]
        folded_ms = call_ms(lambda: quant.forward_folded_f32(tree, xf), 2)[0]
    print(f"phase {phase} (e) dense-lite (compose_lite_dense, "
          f"_forward_folded_dense) vs forward_folded_f32 on {per_cadence} "
          f"crops, TF32 off: max abs err {err:.3g}, relative {rel:.3g}; "
          f"dense-lite {dense_ms:.3f} ms, folded {folded_ms:.3f} ms; the "
          f"phase took {time.perf_counter() - t_phase:.1f} s; card: {card}")
    return {"auction_launches": launches[auction_cuda],
            "osblock_launches": launches[osblock_cuda],
            "int8_launches": launches[int8],
            "auction_err": auction_stats["auction_err"]}


@contextlib.contextmanager
def watched_service(keep=0, capture_at=None):
    """While inside: per TrackingService.step_async, its auction launches
    (``launches``) and wall seconds (``dispatch``, the native mux's
    assemble included, timed apart in ``assemble``); per
    PendingBatch.result, its wall seconds (``fetch``: the wait for the
    card and the copy back); the first ``keep`` batches resolved
    (``batches``); and copies of the auction kernel's inputs in the tick
    at index ``capture_at`` of ``launches`` (``solves``)."""
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.serving import mux, service

    seen = {"launches": [], "dispatch": [], "assemble": [], "fetch": [],
            "batches": []}
    dispatch = service.TrackingService.step_async
    resolve = service.PendingBatch.result
    assemble = mux.StreamMux.assemble
    capturing = [False]

    def counted(self):
        before = auction_cuda.LAUNCHES
        capturing[0] = len(seen["launches"]) == capture_at
        t0 = time.perf_counter()
        try:
            out = dispatch(self)
        finally:
            capturing[0] = False
        seen["dispatch"].append(time.perf_counter() - t0)
        seen["launches"].append(auction_cuda.LAUNCHES - before)
        return out

    def kept(self):
        t0 = time.perf_counter()
        batch = resolve(self)
        seen["fetch"].append(time.perf_counter() - t0)
        if len(seen["batches"]) < keep:
            seen["batches"].append(batch)
        return batch

    def timed_assemble(self):
        t0 = time.perf_counter()
        out = assemble(self)
        seen["assemble"].append(time.perf_counter() - t0)
        return out

    service.TrackingService.step_async = counted
    service.PendingBatch.result = kept
    mux.StreamMux.assemble = timed_assemble
    try:
        with captured_solves(lambda: capturing[0]) as seen["solves"]:
            yield seen
    finally:
        service.TrackingService.step_async = dispatch
        service.PendingBatch.result = resolve
        mux.StreamMux.assemble = assemble


def held_to_plain(label, solves):
    """The auction kernel against the plain auction on each of a tick's
    captured inputs (they must agree exactly); the largest difference."""
    from motcpp_tpu_torch.ops import auction, auction_cuda

    err = 0
    for i, args in enumerate(solves):
        e = matching_err(auction_cuda.solve(*args),
                         auction.solve_lap_auction(*args))
        check(e == 0, f"{label}: kernel and plain auction disagree on the "
              f"tick's solve {i} {tuple(args[0].shape)}")
        err = max(err, e)
    return err


def tick_split(seen, warmup):
    """p50 and p99 ms of the dispatch, assemble and fetch of the ticks
    after the warm-up."""
    parts = []
    for name in ("dispatch", "assemble", "fetch"):
        ms = np.asarray(seen[name][warmup:]) * 1e3
        if ms.size:
            parts.append(f"{name} p50 {np.percentile(ms, 50):.3f} p99 "
                         f"{np.percentile(ms, 99):.3f}")
    return "split (ms): " + ", ".join(parts)


def serving_tail_phase(phase, card):
    """Phase ``phase``: the serving tail-latency harness and the SLO sweep
    in process, through the native mux and the auction kernel (see the
    module docstring, phase 21). Every run's row is printed; none of its
    times is held to a bound. Returns the auction launches of every run
    and the kernel's largest difference from the plain auction."""
    from motcpp_tpu_torch.scripts import serving_latency as harness
    from motcpp_tpu_torch.scripts import slo_sweep
    from motcpp_tpu_torch.serving import TrackingService

    print(f"phase {phase} the serving tail-latency harness and the SLO "
          f"sweep: started; card: {card}")
    t_phase = time.perf_counter()
    launches, max_err = 0, 0
    # the auction's inputs are captured in the last warm-up tick, so no
    # timed tick pays for the copies
    capture_at = harness.parser().get_default("warmup") - 1

    def checked(label, args, row, report, seen):
        """The run's correctness checks; prints its row."""
        nonlocal launches, max_err
        got, want = seen["launches"], STEP_LAUNCHES[args.tracker]
        split = tick_split(seen, args.warmup)
        solves = seen["solves"][:]
        for name in ("launches", "dispatch", "assemble", "fetch"):
            seen[name] = []
        seen["solves"].clear()  # the list captured_solves appends to
        check(len(solves) == want, f"{label}: {len(solves)} auction solves "
              f"captured in tick {capture_at}, want {want}")
        err = held_to_plain(label, solves)
        max_err = max(max_err, err)
        check(report["native_mux"],
              f"{label}: the service was not built on the native mux")
        check(got and set(got) == {want}, f"{label}: auction launches a "
              f"tick {sorted(set(got))}, want {want}")
        presents = report["presents"]
        check(len(presents) == len(got), f"{label}: {len(got)} ticks "
              f"dispatched, {len(presents)} resolved")
        check(set(presents) == {report["live"]}, f"{label}: ticks with "
              f"{sorted(set(presents))} of {report['live']} live streams "
              f"present")
        check(report["stats"]["dropped"] == 0,
              f"{label}: {report['stats']['dropped']} frames dropped")
        qs = [row[k] for k in ("p50", "p90", "p95", "p99", "max")]
        check(bool(np.all(np.isfinite(qs))) and qs == sorted(qs),
              f"{label}: percentiles {qs} are not finite and ordered")
        launches += sum(got)
        shapes = [tuple(a[0].shape) for a in solves]
        print(f"phase {phase} {label}: {len(got)} ticks, {sum(got)} auction "
              f"launches; kernel = plain auction on tick {capture_at}'s "
              f"solves {shapes} (max abs err {err}); {split}; "
              f"{json.dumps(row)}")

    def run(label, argv, keep=0):
        args = harness.parser().parse_args(argv + ["--ticks",
                                                   str(SLO_TICKS)])
        report = {}
        with watched_service(keep, capture_at) as seen:
            row = harness.measure(args, report=report)
        checked(label, args, row, report, seen)
        return seen["batches"]

    # (a) the harness at its defaults: producer threads, native mux
    run("(a) ByteTrack S=1024, 4 producers", [])
    run("(a) ByteTrack S=1024, 4 producers, pipelined", ["--pipeline"])

    # (b) the flagship in device-data mode against the native mux
    kept = run(f"(b) ByteTrack S={S} device data",
               ["--streams", str(S), "--max-dets", str(N),
                "--max-tracks", str(K), "--objects", str(N_OBJ),
                "--device-data"], keep=RING_EQUAL_TICKS)
    dets, masks = harness.staged_frames(RING_EQUAL_TICKS, S, N, N_OBJ)
    svc = TrackingService.from_tracker(
        "bytetrack", S, max_dets=N,
        tracker_kw=dict(max_tracks=K, lap_impl="auction_pallas"),
        device="cuda")
    hs = [svc.attach() for _ in range(S)]
    emitted = 0
    for t, got in enumerate(kept):
        for s, h in enumerate(hs):
            svc.submit(h, dets[t, s, :int(masks[t, s].sum())])
        want = svc.step()
        same = (np.array_equal(got.out_masks, want.out_masks)
                and np.array_equal(got.outs[got.out_masks],
                                   want.outs[want.out_masks]))
        check(same, f"(b) tick {t}: the staged ring's emissions differ from "
              f"the same dets through the native mux")
        emitted += int(got.out_masks.sum())
    check(len(kept) == RING_EQUAL_TICKS and emitted > 0,
          f"(b) {len(kept)} ticks kept, {emitted} emissions")
    print(f"phase {phase} (b) the first {len(kept)} device-data ticks = the "
          f"same dets through the native mux bit for bit ({emitted} "
          f"emissions)")
    del svc, kept
    harness_s = time.perf_counter() - t_phase

    # (c) the SLO sweep
    t_sweep = time.perf_counter()
    with watched_service(capture_at=capture_at) as seen:
        def on_run(args, row, report):
            mode = ("device data" if args.device_data
                    else f"{args.producers} producers")
            checked(f"(c) {args.tracker} S={args.streams} {mode}", args, row,
                    report, seen)

        record = slo_sweep.sweep(ticks=SLO_TICKS,
                                 run=slo_sweep.Harness(on_run=on_run))
    errors = [r for r in record["rows"] if "error" in r]
    check(not errors, f"(c) sweep rows with errors: {errors}")
    for row in record["rows"]:
        print(f"phase {phase} (c) row: {json.dumps(row)}")
    print(f"phase {phase} (c) summary (p99 <= {slo_sweep.SLO_MS} ms; card "
          f"{record['_meta']['card']}): {json.dumps(record['summary'])}")
    sweep_s = time.perf_counter() - t_sweep
    print(f"phase {phase} wall time {time.perf_counter() - t_phase:.1f} s: "
          f"(a) and (b) {harness_s:.1f} s, the sweep {sweep_s:.1f} s")
    return {"auction_launches": launches, "auction_err": max_err}


def attribution_phase(phase, card, block_ms):
    """Phase ``phase``: the time-attribution tools of
    ``motcpp_tpu_torch/scripts/``, in process, on the card. (a)
    profile_osnet at PROFILE_CROPS crops of osnet_x1_0, bf16, 256x128,
    ``--fused --roofline``: the fused forward's per-crop cosine to the
    module forward in float32 (TF32 off), each piece alone in bf16 to
    float32 and fused to module, and each OSBlock kernel row's cosine to
    its plain version at least 0.999, and the six kernel block rows
    within 20% of ``block_ms``, phase 7's six-block kernel time; (b)
    profile_stages at S streams, every stage: the kernel's row2col and
    col2row equal to the plain auction's; (c) ablate_cost on
    ABLATE_TRACKERS at OC_S streams, ABLATE_T frames, ablating the LAP and
    the IoU: every ablated stub called, and the device split of the
    unstubbed rollout measured with the LAP's kernels in it; (d)
    microbench_select at SELECT_STREAMS streams: every case exact.
    Returns both kernels' launches in the tools' measured runs (their
    warm-up calls and comparison launches are not counted) and their
    largest differences from their plain versions."""
    from motcpp_tpu_torch.appearance import osblock_cuda
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.scripts import (
        ablate_cost,
        microbench_select,
        profile_osnet,
        profile_stages,
    )

    t_phase = time.perf_counter()
    counters = (osblock_cuda, auction_cuda)
    for m in counters:
        m.LAUNCHES = 0
    split = {}

    # (a) the per-piece OSNet profile
    print(f"phase {phase} (a) profile_osnet, osnet_x1_0 {PROFILE_CROPS} "
          f"crops bf16; card: {card}", flush=True)
    t0 = time.perf_counter()
    osnet = profile_osnet.profile(profile_osnet.parser().parse_args(
        ["--batch", str(PROFILE_CROPS), "--dtype", "bfloat16", "--hw",
         *map(str, CROP_HW), "--fused",
         "--roofline", "--repeats", str(PROFILE_REPEATS)]))
    cos32 = osnet["cosine_f32"][0]
    check(cos32 >= 0.999, f"(a) fused vs module forward in float32: min "
          f"cosine {cos32:.6f} < 0.999")
    for r in osnet["pieces_precision"]:
        low = min(r["module"], r["fused"], r["fused_module"])
        check(low >= 0.999, f"(a) {r['name']} alone in bf16: min cosine "
              f"{low:.6f} < 0.999 (module {r['module']:.6f}, fused "
              f"{r['fused']:.6f} to float32, fused to module "
              f"{r['fused_module']:.6f})")
    blocks = [r for r in osnet["fused_rows"]
              if r["name"] in profile_osnet.BLOCKS]
    for r in blocks:
        check(r["cosine"] >= 0.999, f"(a) {r['name']}: the kernel's min "
              f"cosine to its plain version {r['cosine']:.6f} < 0.999")
    k_ms = sum(r["ms"] for r in blocks)
    check(len(blocks) == 6 and abs(k_ms / block_ms - 1) <= 0.2,
          f"(a) the six kernel block rows {k_ms:.3f} ms, phase 7's six "
          f"blocks {block_ms:.3f} ms: not within 20%")
    split["a"] = time.perf_counter() - t0
    to32 = osnet["cosine_to_f32"]
    low = min(min(r["module"], r["fused"], r["fused_module"])
              for r in osnet["pieces_precision"])
    print(f"phase {phase} (a) min cosine of the fused to the module forward: "
          f"float32 {cos32:.7f} (held), bf16 {osnet['cosine'][0]:.5f}; of "
          f"the bf16 forwards to float32: module {to32['module'][0]:.5f}, "
          f"fused {to32['fused'][0]:.5f} (printed: rounding grown through "
          f"depth); each piece alone in bf16, to float32 and fused to "
          f"module, {low:.6f} at least (held); the six kernel block rows "
          f"{k_ms:.3f} ms = {k_ms / block_ms:.3f}x phase 7's "
          f"{block_ms:.3f} ms; {split['a']:.1f} s", flush=True)

    # (b) the stage microbenchmarks
    t0 = time.perf_counter()
    stages = profile_stages.measure(profile_stages.parser().parse_args(
        ["--streams", str(S), "--iters", str(STAGE_ITERS), "--stages",
         *profile_stages.STAGES]))
    check(stages["pallas_equal"], "(b) the auction kernel's row2col and "
          "col2row differ from the plain auction's")
    split["b"] = time.perf_counter() - t0

    # (c) the stage ablation
    t0 = time.perf_counter()
    for tracker in ABLATE_TRACKERS:
        ablated = ablate_cost.ablate(ablate_cost.parser().parse_args(
            ["--tracker", tracker, "--streams", str(OC_S), "--frames",
             str(ABLATE_T), "--repeats", str(ABLATE_REPEATS)]))
        calls, shares = ablated["calls"], ablated["split"]
        check(set(calls) == {"lap", "iou"} and all(calls.values()),
              f"(c) {tracker}: ablated stubs called {calls}")
        check(shares is not None and (shares["stages"]["lap"][0] or 0) > 0,
              f"(c) {tracker}: no device time inside the LAP's ranges")
    split["c"] = time.perf_counter() - t0

    # (d) the select microbench
    t0 = time.perf_counter()
    select = microbench_select.measure(microbench_select.parser().parse_args(
        ["--streams", str(SELECT_STREAMS), "--repeats", str(SELECT_REPEATS)]))
    inexact = [r[0] for r in select["rows"] if not r[3]]
    check(not inexact, f"(d) cases not exact: {inexact}")
    split["d"] = time.perf_counter() - t0

    launches = {m: m.LAUNCHES for m in counters}
    check(all(launches.values()), f"phase {phase} launched a kernel no "
          f"time: {[m.__name__ for m in counters if not launches[m]]}")
    print(f"phase {phase} wall time {time.perf_counter() - t_phase:.1f} s: "
          + ", ".join(f"({k}) {v:.1f}" for k, v in split.items())
          + f"; launches: auction {launches[auction_cuda]}, OSBlock "
          f"{launches[osblock_cuda]}; card: {card}", flush=True)
    return {"auction_launches": launches[auction_cuda],
            "osblock_launches": launches[osblock_cuda],
            "auction_err": 0,
            "osblock_err": max(r["max_abs_err"] for r in blocks)}



def long_horizon_phase(phase, card):
    """Phase ``phase``: motcpp_tpu_torch/scripts/longrun_stability.py in
    process, its scene made on the card. (a) its defaults but
    LONG_FRAMES frames: ByteTrack, 256 streams, in chunks of 500 through
    run(), every emitted row finite; (b) OC-SORT over LONG_OC_FRAMES
    frames (its observation ring wraps); (c) (a)'s first LONG_EQUAL_CHUNKS
    chunks again as one run() of a fresh runner: masks, ids, boxes and
    the carried state equal to (a)'s bit for bit; (d) the kernel on the
    solves of (a)'s last frame held to the plain auction (max abs err 0)
    and timed beside it and its bound; (e) (a), (b) and (c) launch the
    kernel exactly twice a frame; and profiles of 10 frames of (a)'s path
    (after (c)'s frames) and (b)'s (frames 10-19 of a fresh run). Returns
    the launches of (a) and (b) ((c) is a comparison) and (d)'s largest
    difference."""
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
    from motcpp_tpu_torch.scripts import longrun_stability as longrun
    from motcpp_tpu_torch.scripts.tracker_fns import build_tracker_fns

    t_phase = time.perf_counter()
    args = longrun.parser().parse_args(["--frames", str(LONG_FRAMES)])
    n_chunks = -(-args.frames // args.chunk)
    kept, state_at, after = [], [], []
    seen = [None]  # solves of (a)'s last chunk so far, once it starts

    def last_frame():  # the last frame's two solves
        if seen[0] is None:
            return False
        seen[0] += 1
        return seen[0] > 2 * (args.chunk - 1)

    def on_chunk(c, runner, dets, masks, outs, out_masks):
        if c < LONG_EQUAL_CHUNKS:
            kept.append((dets, masks, outs, out_masks))
        if c == LONG_EQUAL_CHUNKS - 1:
            state_at.append(runner.states)
        if c == LONG_EQUAL_CHUNKS:  # the frames that follow, to profile
            after.extend([(dets[:10], masks[:10]), (dets[10:20],
                                                    masks[10:20])])
        if c == n_chunks - 2:
            seen[0] = 0

    split, launches = {}, {}
    for key, argv, hook in (
            ("a", ["--frames", str(LONG_FRAMES)], on_chunk),
            ("b", ["--tracker", "ocsort", "--frames", str(LONG_OC_FRAMES)],
             None)):
        auction_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        try:
            with captured_solves(last_frame) as got:
                rep = longrun.run(longrun.parser().parse_args(argv),
                                  on_chunk=hook)
        finally:
            seen[0] = None
        if key == "a":
            last = got
        split[key] = time.perf_counter() - t0
        launches[key] = auction_cuda.LAUNCHES
        label = f"({key}) {rep['tracker']}"
        check(rep["failed"] is None, f"{label}: a non-finite emission in "
              f"chunk {rep['failed']}")
        check(rep["emissions"] > 0, f"{label}: no emission")
        check(launches[key] == 2 * rep["frames"],
              f"(e) {label}: {launches[key]} kernel launches over "
              f"{rep['frames']} frames, want 2 a frame")
        ms = np.asarray(rep["chunk_ms"])
        print(f"phase {phase} {label} S={rep['streams']} K={args.max_tracks}"
              f" N={args.max_dets}, {rep['frames']} frames in run() calls of "
              f"{args.chunk}: ms per frame-batch median "
              f"{np.median(ms):.3f} over the chunks (first {ms[0]:.3f}, min "
              f"{ms.min():.3f}, max {ms.max():.3f}), "
              f"{rep['emissions']} emissions, largest emitted id "
              f"{rep['max_emitted_id']}, largest next_id "
              f"{rep['max_next_id']}, non-finite state fields "
              f"{rep['nonfinite_leaves']}, {launches[key]} kernel launches "
              f"(2 a frame), {split[key]:.1f} s; card: {card}", flush=True)

    # (c) the leading chunks as one run()
    t0 = time.perf_counter()
    init, step = build_tracker_fns("bytetrack", args.max_tracks,
                                   args.max_dets, args.lap, device="cuda")
    whole = MultiStreamRunner(init, step, args.streams, device="cuda")
    auction_cuda.LAUNCHES = 0
    outs, out_masks = whole.run(torch.cat([k[0] for k in kept]),
                                torch.cat([k[1] for k in kept]))
    launches["c"] = auction_cuda.LAUNCHES
    frames = outs.shape[0]
    check(launches["c"] == 2 * frames, f"(c) {launches['c']} kernel "
          f"launches over {frames} frames, want 2 a frame")
    emitted, _ = same_outputs(
        f"(c) one run() of {frames} frames against {LONG_EQUAL_CHUNKS} "
        f"chunks of {args.chunk}", (outs, out_masks),
        (torch.cat([k[2] for k in kept]), torch.cat([k[3] for k in kept])))
    fields = [f for f, a, b in zip(whole.states._fields, whole.states,
                                   state_at[0]) if not same_bits(a, b)]
    check(not fields, f"(c) the carried state after {frames} frames "
          f"differs from the chunked run's in {fields}")
    split["c"] = time.perf_counter() - t0
    print(f"phase {phase} (c) {LONG_EQUAL_CHUNKS} chunks of {args.chunk} = "
          f"one run() of {frames} frames: masks, ids, boxes "
          f"({emitted} emissions) and the carried state identical bit for "
          f"bit; {launches['c']} kernel launches (2 a frame; a comparison, "
          f"so not in the count); {split['c']:.1f} s", flush=True)
    del kept, outs, out_masks

    # profiles of 10 frames of (a)'s and (b)'s paths
    print(f"phase {phase} (a) ByteTrack profile of 10 frames after frame "
          f"{frames + 10}: {profile_split(whole.run, after, frames=10)[1]}; "
          f"card: {card}", flush=True)
    scene_init, scene_chunk = longrun.make_device_scene(
        args.streams, args.max_dets, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, dets, masks = scene_chunk(gen, scene_init(gen), 20)
    init, step = build_tracker_fns("ocsort", args.max_tracks, args.max_dets,
                                   args.lap, device="cuda")
    fresh = MultiStreamRunner(init, step, args.streams, device="cuda")
    _, line = profile_split(fresh.run, [(dets[:10], masks[:10]),
                                        (dets[10:], masks[10:])], frames=10)
    print(f"phase {phase} (b) OC-SORT profile of frames 10-19 of a fresh "
          f"run: {line}; card: {card}", flush=True)

    # (d) the kernel on the solves of (a)'s last frame
    stats = solves_on_path(phase, "ByteTrack long-run (last frame)",
                           ("stage 1", "stages 2+3"), last, card)
    total = launches["a"] + launches["b"]
    print(f"phase {phase} wall time {time.perf_counter() - t_phase:.1f} s: "
          + ", ".join(f"({k}) {v:.1f}" for k, v in split.items())
          + f"; auction launches on (a) and (b) {total}; card: {card}",
          flush=True)
    return dict(stats, auction_launches=total)


def obb_sof_phase(phase, card):
    """Phase ``phase``. Oriented-box SORT (``is_obb``, min_hits=1,
    max_age=3) under MultiStreamRunner at OBB_S streams, OBB_T frames of
    data/synthetic.py::obb_stream_dets (seed 0): one warm-up and
    OBB_REPEATS timed runs (one launch a frame), the peak device memory,
    the kernel on the path's inputs beside its bound, a profile of its
    last 10 frames split by the IoU's range (which must hold device
    time), the kernel path against the plain auction path on
    EQUAL_STREAMS streams (identical) and the card against the CPU on
    OBB_HOST_S streams (masks and ids identical, boxes within
    OBB_BOX_ATOL). Then the runner's live sparse-flow leg: StrongSORT
    (n_init=1, gallery_cap=16) with cmc_fn=sof_jax_batch at CMC scale
    CMC_SCALE, CMC_S streams, SOF_T frames of 162x288 panning textures
    made on the card: the warps of one pair against the known pans
    (within SOF_PAN_ATOL, ok everywhere), sof_jax_batch's device time on
    one pair, one warm-up and SOF_REPEATS timed runs (two launches a
    frame), a profile of the second half of the frames, the kernel on
    the inputs of the middle frame beside its bound, the rollout over
    two run() calls against one (identical), the card against the CPU on
    SOF_HOST_S streams and SOF_HOST_T frames (masks and ids identical,
    boxes within SOF_BOX_ATOL; the first differing frame and stream
    named otherwise), and a run without camera motion, which must
    differ. Returns the timed runs' launches and the largest difference
    of the kernel from the plain auction on either path."""
    from motcpp_tpu_torch.data import obb_stream_dets, pan_frames
    from motcpp_tpu_torch.data import synth_stream_dets
    from motcpp_tpu_torch.models import sort as sort_module
    from motcpp_tpu_torch.motion.cmc import sof_jax_batch
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.parallel.streams import MultiStreamRunner
    from motcpp_tpu_torch.scripts.tracker_fns import build_tracker_fns

    t_phase = time.perf_counter()
    split, launches = {}, {}

    def timed(runner, dets, masks, repeats, per_frame, label, **legs):
        """timed_runs with the launches of all its runs and a check that
        the last run emits, each emitted row finite."""
        auction_cuda.LAUNCHES = 0
        run_s, times, _, (outs, out_masks) = timed_runs(
            runner, dets, masks, (auction_cuda,),
            {auction_cuda: per_frame * dets.shape[0]}, label, repeats, **legs)
        emitted = int(out_masks.sum())
        check(emitted > 0 and bool(torch.isfinite(outs[out_masks]).all()),
              f"{label}: {emitted} emissions, or a non-finite one")
        return outs, out_masks, run_s, times, auction_cuda.LAUNCHES

    # ---- oriented-box SORT ------------------------------------------------
    t0 = time.perf_counter()

    def make_obb(lap, device="cuda"):
        return sort_module.make_sort(sort_module.SortConfig(
            is_obb=True, min_hits=1, max_age=3, max_tracks=K, max_dets=N,
            lap_impl=lap), device=device)

    dets_np, masks_np = obb_stream_dets(np.random.default_rng(0), OBB_T,
                                        OBB_S, N, n_obj=N_OBJ)
    dets = torch.from_numpy(dets_np).cuda()
    masks = torch.from_numpy(masks_np).cuda()
    init, step = make_obb("auction_pallas")
    runner = MultiStreamRunner(init, step, OBB_S, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    outs, out_masks, run_s, times, launches["obb"] = timed(
        runner, dets, masks, OBB_REPEATS, 1, "OBB SORT")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(outs.shape == (OBB_T, OBB_S, K, 9), f"OBB SORT output "
          f"{tuple(outs.shape)}")
    print(f"phase {phase} OBB SORT main path S={OBB_S} K={K} N={N} "
          f"T={OBB_T}: {run_s * 1e3 / OBB_T:.3f} ms per frame-batch (median "
          f"of {OBB_REPEATS}, runs {[round(t * 1e3, 1) for t in times]} ms),"
          f" {OBB_S * OBB_T / run_s / 30:.0f} streams at 30 FPS, "
          f"{int(out_masks.sum())} emissions in the last run, "
          f"{launches['obb']} kernel launches, peak device memory "
          f"{peak_gb:.2f} GB; card: {card}", flush=True)
    half = OBB_T // 2
    runner.reset()
    runner.run(dets[:half], masks[:half])
    stats = auction_on_path(
        phase, "OBB SORT", ("stage 1",),
        lambda: runner.run(dets[half:half + 1], masks[half:half + 1]), card)
    warm, prof_sl = slice(half + 1, OBB_T - 10), slice(OBB_T - 10, OBB_T)
    _, line = profile_split(
        runner.run, [(dets[warm], masks[warm]),
                     (dets[prof_sl], masks[prof_sl])],
        [(sort_module, "iou_batch_obb", "iou_batch_obb")], frames=10)
    print(f"phase {phase} OBB SORT profile of its last 10 frames: {line}; "
          f"card: {card}", flush=True)
    d, m = dets[:, :EQUAL_STREAMS], masks[:, :EQUAL_STREAMS]
    pi, ps = make_obb("auction")
    equal, _ = same_outputs(
        "OBB SORT kernel path against the plain path",
        MultiStreamRunner(init, step, EQUAL_STREAMS, device="cuda").run(d, m),
        MultiStreamRunner(pi, ps, EQUAL_STREAMS, device="cuda").run(d, m),
        id_col=5)
    hi, hs = make_obb("auction_pallas", device="cpu")
    d, m = dets_np[:, :OBB_HOST_S], masks_np[:, :OBB_HOST_S]
    _, obb_err = same_outputs(
        "OBB SORT card against CPU",
        MultiStreamRunner(init, step, OBB_HOST_S, device="cuda").run(d, m),
        MultiStreamRunner(hi, hs, OBB_HOST_S, device="cpu").run(d, m),
        OBB_BOX_ATOL, slice(0, 5), 5)
    split["obb"] = time.perf_counter() - t0
    print(f"phase {phase} OBB SORT kernel path = plain path on "
          f"{EQUAL_STREAMS} streams: identical ({equal} emissions);"
          f" card = CPU on {OBB_HOST_S} streams: masks and ids identical, "
          f"boxes within {obb_err:.2e} px; {split['obb']:.1f} s", flush=True)
    del dets, masks, outs, out_masks

    # ---- the live sparse-flow leg -----------------------------------------
    t0 = time.perf_counter()
    fh, fw = int(1080 * CMC_SCALE), int(1920 * CMC_SCALE)
    frames, pans = pan_frames(SOF_T, CMC_S, fh, fw,
                              torch.Generator(device="cuda").manual_seed(0))
    w, ok = sof_jax_batch(frames[0], frames[1])
    err_x = float((w[:, 0, 2] + pans.float()).abs().max())
    err_y = float(w[:, 1, 2].abs().max())
    check(bool(ok.all()), f"SOF failed on {int((~ok).sum())} streams")
    check(err_x <= SOF_PAN_ATOL and err_y <= SOF_PAN_ATOL, f"SOF warps miss "
          f"the pans by {err_x:.2e} px in x, {err_y:.2e} px in y "
          f"(> {SOF_PAN_ATOL})")
    hw, _ = sof_jax_batch(frames[0, :SOF_HOST_S].cpu(),
                          frames[1, :SOF_HOST_S].cpu())
    warp_err = float((w[:SOF_HOST_S].cpu() - hw).abs().max())
    sof_ms = call_ms(lambda: sof_jax_batch(frames[0], frames[1]), 1)[0]
    print(f"phase {phase} sof_jax_batch on one frame pair, S={CMC_S} "
          f"{(fh, fw)}: warps x = -pan within {err_x:.2e} px, y within "
          f"{err_y:.2e} px, ok on every stream; {sof_ms:.3f} ms of device "
          f"time; the card's warps of {SOF_HOST_S} streams within "
          f"{warp_err:.2e} of the CPU's; card: {card}", flush=True)
    ss_init, ss_step = build_tracker_fns("strongsort", K, N, "auction_pallas",
                                         device="cuda")
    sdets_np, smasks_np = synth_stream_dets(np.random.default_rng(0), SOF_T,
                                            CMC_S, N, n_obj=N_OBJ)
    sdets = torch.from_numpy(sdets_np).cuda()
    smasks = torch.from_numpy(smasks_np).cuda()

    def live(streams, device="cuda", fns=(ss_init, ss_step)):
        return MultiStreamRunner(*fns, streams, device=device,
                                 cmc_fn=sof_jax_batch, cmc_scale=CMC_SCALE)

    lo, lm, run_s, times, launches["sof"] = timed(
        live(CMC_S), sdets, smasks, SOF_REPEATS, 2, "live SOF",
        frames=frames)
    print(f"phase {phase} StrongSORT live SOF main path S={CMC_S} K={K} "
          f"N={N} T={SOF_T}, frames {(fh, fw)} at CMC scale {CMC_SCALE}: "
          f"{run_s * 1e3 / SOF_T:.3f} ms per frame-batch (median of "
          f"{SOF_REPEATS}, runs {[round(t * 1e3, 1) for t in times]} ms), "
          f"{CMC_S * SOF_T / run_s / 30:.1f} streams at 30 FPS, "
          f"{int(lm.sum())} emissions in the last run, {launches['sof']} "
          f"kernel launches; card: {card}", flush=True)
    half = SOF_T // 2
    runner = live(CMC_S)
    _, line = profile_split(
        lambda d, m, f: runner.run(d, m, frames=f),
        [(sdets[sl], smasks[sl], frames[sl])
         for sl in (slice(0, half), slice(half, SOF_T))], frames=SOF_T - half)
    print(f"phase {phase} StrongSORT live SOF profile of frames {half}-"
          f"{SOF_T - 1} of a fresh run: {line}; card: {card}", flush=True)
    runner.reset()
    runner.run(sdets[:half], smasks[:half], frames=frames[:half])
    sof_stats = auction_on_path(
        phase, "StrongSORT live SOF", ("stage A", "stage B"),
        lambda: runner.run(sdets[half:half + 1], smasks[half:half + 1],
                           frames=frames[half:half + 1]), card)
    two = live(CMC_S)
    parts = [two.run(sdets[sl], smasks[sl], frames=frames[sl])
             for sl in (slice(0, half), slice(half, SOF_T))]
    same_outputs("live SOF over two run() calls against one",
                 (torch.cat([p[0] for p in parts]),
                  torch.cat([p[1] for p in parts])), (lo, lm))
    hfns = build_tracker_fns("strongsort", K, N, "auction_pallas",
                             device="cpu")
    sl = (slice(0, SOF_HOST_T), slice(0, SOF_HOST_S))
    host_frames = frames[sl].cpu()
    _, sof_err = same_outputs(
        "live SOF card against CPU",
        live(SOF_HOST_S).run(sdets[sl], smasks[sl], frames=frames[sl]),
        live(SOF_HOST_S, "cpu", hfns).run(sdets_np[sl], smasks_np[sl],
                                          frames=host_frames),
        SOF_BOX_ATOL)
    no, nm = MultiStreamRunner(ss_init, ss_step, CMC_S,
                               device="cuda").run(sdets, smasks)
    check(not (torch.equal(nm, lm) and same_bits(no[nm], lo[lm])),
          "live SOF: a run without camera motion emits the same tracks")
    split["sof"] = time.perf_counter() - t0
    print(f"phase {phase} live SOF over two run() calls = one call: "
          f"identical ({int(lm.sum())} emissions); card = CPU on "
          f"{SOF_HOST_S} streams x {SOF_HOST_T} frames: masks and ids "
          f"identical, boxes within {sof_err:.2e} px; without camera motion "
          f"{int(nm.sum())} emissions, {int((nm != lm).sum())} slots differ; "
          f"{split['sof']:.1f} s", flush=True)
    del frames
    total = launches["obb"] + launches["sof"]
    print(f"phase {phase} wall time {time.perf_counter() - t_phase:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; auction launches {total} (OBB {launches['obb']}, SOF "
          f"{launches['sof']}); card: {card}", flush=True)
    return dict(stats, auction_launches=total,
                auction_err=max(stats["auction_err"],
                                sof_stats["auction_err"]))


def host_scoreboard(trackers):
    """The scoreboard's ``trackers`` at SCORE_FRAMES on the host through
    the plain auction, at one torch thread: phase 25 (c)'s rows, run in a
    worker process beside the card's rows. Returns the rows and their
    seconds."""
    from motcpp_tpu_torch.scripts.ablation_benchmark import run_scoreboard

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    rows = run_scoreboard(SCORE_FRAMES, list(trackers), progress=len,
                          device="cpu", lap_impl="auction")
    return rows, time.perf_counter() - t0


@contextlib.contextmanager
def watched_scoreboard(capture=()):
    """While inside: each tracker that ``motcpp_tpu_torch.create_tracker``
    builds records, per ``update()``, its output, its auction launches
    and its wall seconds (``seen["rows"]``, one dict a tracker in the
    order they are built), and the scoreboard's metrics their wall
    seconds (``seen["metrics_s"]``); for each (model, frame) in
    ``capture``, the auction kernel's inputs in that frame of the first
    tracker of that model are copied into ``seen["solves"][(model,
    frame)]``."""
    import motcpp_tpu_torch
    from motcpp_tpu_torch import metrics
    from motcpp_tpu_torch.ops import auction_cuda

    seen = {"rows": [], "metrics_s": [0.0], "solves": {}}
    create = motcpp_tpu_torch.create_tracker
    scores = {n: getattr(metrics, n) for n in
              ("clear_metrics", "identity_metrics", "hota_metrics")}

    def watched(model, **kw):
        tracker = create(model, **kw)
        row = {"model": model, "outs": [], "launches": [], "update_s": 0.0}
        seen["rows"].append(row)
        update = tracker.update

        def recorded(*args, **kwargs):
            key = (model, len(row["outs"]) + 1)
            before = auction_cuda.LAUNCHES
            t0 = time.perf_counter()
            if key in capture and key not in seen["solves"]:
                with captured_solves() as seen["solves"][key]:
                    out = update(*args, **kwargs)
            else:
                out = update(*args, **kwargs)
            row["update_s"] += time.perf_counter() - t0
            row["launches"].append(auction_cuda.LAUNCHES - before)
            row["outs"].append(out)
            return out

        tracker.update = recorded
        return tracker

    def timed(fn):
        def score(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seen["metrics_s"][0] += time.perf_counter() - t0
        return score

    motcpp_tpu_torch.create_tracker = watched
    for name, fn in scores.items():
        setattr(metrics, name, timed(fn))
    try:
        yield seen
    finally:
        motcpp_tpu_torch.create_tracker = create
        for name, fn in scores.items():
            setattr(metrics, name, fn)


@contextlib.contextmanager
def scene_once():
    """While inside, ``data/synthetic.py::ablation_scene`` makes each
    length of scene once and hands the same one to every later call (the
    scoreboard's runs only read it)."""
    from motcpp_tpu_torch.data import synthetic

    make, scenes = synthetic.ablation_scene, {}

    def scene(n_frames):
        if n_frames not in scenes:
            scenes[n_frames] = make(n_frames=n_frames)
        return scenes[n_frames]

    synthetic.ablation_scene = scene
    try:
        yield
    finally:
        synthetic.ablation_scene = make


def card_probes():
    """Phase 25 (b) and (d) on the card, in a worker process beside (a):
    SCORE_POINTS through the auction kernel, every priority selection
    also made on the host, then BoostTrack's plain row again. Returns
    each point's (tracker, probe, metrics, row record without its
    outputs), the frames whose selection differed, BoostTrack's metrics
    and row record, the kernel launches of (b) (the worker's count, from
    0; (d) is a comparison and not counted) and the seconds of both."""
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.scripts import ablation_benchmark as ab

    torch.set_num_threads(1)
    kernel = dict(device="cuda", lap_impl="auction_pallas")
    select, differ, points, split = ab.budget_select, [], [], {}

    def held_select(d_now, prev_d, t, f, policy, device):
        sel = select(d_now, prev_d, t, f, policy, device)
        if not np.array_equal(sel, select(d_now, prev_d, t, f, policy,
                                          "cpu")):
            differ.append(t)
        return sel

    auction_cuda.LAUNCHES = 0
    ab.budget_select = held_select
    try:
        with scene_once():
            t0 = time.perf_counter()
            for names, probe in SCORE_POINTS:
                with watched_scoreboard() as seen:
                    got = ab.run_scoreboard(SCORE_FRAMES, list(names),
                                            progress=len, **probe, **kernel)
                points += [(name, probe, m, dict(row, outs=None))
                           for (name, m), row in zip(got.items(),
                                                     seen["rows"])]
            split["b"] = time.perf_counter() - t0
            launches = auction_cuda.LAUNCHES
            t0 = time.perf_counter()
            with watched_scoreboard() as seen:
                again = ab.run_scoreboard(SCORE_FRAMES, ["boosttrack"],
                                          progress=len, **kernel)
            split["d"] = time.perf_counter() - t0
    finally:
        ab.budget_select = select
    return dict(points=points, differ=differ, again=again["boosttrack"],
                again_row=seen["rows"][0], launches=launches, split=split)


def scale_bars(r):
    """The JAX package's orderings and scale bars on the scoreboard's rows
    ``r`` (tests/test_accuracy_ablation.py::test_reference_band_orderings
    and test_no_warmup_collapse_at_scale)."""
    check(r["bytetrack"]["HOTA"] > r["sort"]["HOTA"] + 2
          and r["bytetrack"]["IDF1"] > r["sort"]["IDF1"] + 4,
          "(a) ByteTrack not above SORT on HOTA and IDF1")
    for name in ("ocsort", "ucmctrack"):
        check(r[name]["HOTA"] > r["sort"]["HOTA"]
              and r["bytetrack"]["HOTA"] - r[name]["HOTA"] < 8,
              f"(a) {name} outside the band below ByteTrack")
    check(abs(r["ocsort"]["HOTA"] - r["ucmctrack"]["HOTA"]) < 5,
          "(a) OC-SORT and UCMCTrack not within 5 HOTA")
    band = ("sort", "bytetrack", "ocsort", "ucmctrack")
    check(r["sort"]["IDF1"] == min(r[k]["IDF1"] for k in band)
          and r["sort"]["IDSW"] == max(r[k]["IDSW"] for k in band),
          "(a) SORT not the lowest IDF1 and most IDSW of the band")
    for name in ("strongsort", "ucmctrack"):
        check(r[name]["MT"] >= 50
              and r[name]["HOTA"] >= r["bytetrack"]["HOTA"] - 12,
              f"(a) {name} collapses at scale: {r[name]}")
    for name, m in r.items():
        check(m["MT"] >= 40 and m["ML"] <= 10 and m["HOTA"] >= 60,
              f"(a) {name} tracks too few identities: {m}")


def scoreboard_phase(phase, card):
    """Phase ``phase``: motcpp_tpu_torch/scripts/ablation_benchmark.py in
    process on the card through the auction kernel (lap_impl=
    "auction_pallas") at SCORE_FRAMES frames. (a) every SCOREBOARD row:
    each row the JAX package commits (tests/accuracy_ablation.json) within
    SCORE_HOTA_BAR HOTA of it, MOTA, IDF1, DetA, AssA and IDSW printed
    beside it, the JAX package's scale assertions on every row
    (scale_bars), each row's seconds, its update() calls' share, its
    launches a frame, and the scoring's seconds; (b) bench.py's DEPLOYED
    points (SCORE_POINTS), each within SCORE_HOTA_BAR of its committed row
    (tests/accuracy_cadence.json, tests/accuracy_budget.json), its cost
    against (a)'s every-frame row printed beside the committed cost, and
    every frame's priority selection on the card equal to the host's; (c)
    SCORE_HOST_ROWS on the host through the plain auction: the card's rows
    within SCORE_HOST_ATOL on HOTA, MOTA, IDF1, DetA and AssA; (d)
    BoostTrack again on the card: metrics and every update()'s output
    identical to (a)'s; (e) the kernel on the solves of the middle frame
    of each SCORE_SOLVE_ROWS row held to the plain auction (max abs err
    0) and timed beside it and its bound. (b) with (d) (card_probes) and
    (c) (host_scoreboard) run in two spawned worker processes while this
    one runs (a): the paths are bound by the host's launches, and the
    card takes the two processes' kernels in turn. Returns the launches
    of (a) and (b), each process's counted from 0 ((d) is a
    comparison), and (e)'s largest difference."""
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.scripts import ablation_benchmark as ab

    t_phase = time.perf_counter()
    committed = json.loads((TESTS / "accuracy_ablation.json").read_text())
    cadence = json.loads((TESTS / "accuracy_cadence.json").read_text())
    budget = json.loads((TESTS / "accuracy_budget.json").read_text())
    keys = ("HOTA", "MOTA", "IDF1", "DetA", "AssA")
    middle = SCORE_FRAMES // 2

    def rows_line(label, got, want=None):
        """got's metrics, want's beside them where given."""
        def cell(k):
            return (f"{k} {got[k]}" if want is None or k not in want
                    else f"{k} {got[k]} ({want[k]})")
        return (f"phase {phase} {label}: "
                + ", ".join(cell(k) for k in keys + ("IDSW", "MT", "ML")))

    def row_stats(row):
        n = len(row["launches"])
        check(n == SCORE_FRAMES, f"{row['model']}: {n} update() calls, want "
              f"{SCORE_FRAMES}")
        per = np.asarray(row["launches"])
        check(per.min() >= 1, f"{row['model']}: a frame without an auction "
              "kernel launch")
        return (f"{per.sum()} launches ({per.min()}-{per.max()} a frame), "
                f"update() {row['update_s']:.1f} s "
                f"({1e3 * row['update_s'] / n:.2f} ms a frame)")

    with ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        host = pool.submit(host_scoreboard, SCORE_HOST_ROWS)
        probes = pool.submit(card_probes)

        # ---- (a) every row through the kernel --------------------------
        auction_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        row_s, last = [], [t0]

        def progress(line):
            now = time.perf_counter()
            row_s.append(now - last[0])
            last[0] = now

        with watched_scoreboard(capture=tuple(
                (model, middle) for model in SCORE_SOLVE_ROWS)) as seen:
            rows = ab.run_scoreboard(SCORE_FRAMES, progress=progress,
                                     device="cuda", lap_impl="auction_pallas")
        launches = auction_cuda.LAUNCHES
        a_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        probed = probes.result()
        host_rows, host_s = host.result()
        wait_s = time.perf_counter() - t0

    check(list(rows) == list(ab.SCOREBOARD), f"(a) rows {list(rows)}")
    for (name, m), row, s in zip(rows.items(), seen["rows"], row_s):
        want = committed.get(name)
        print(rows_line(f"(a) {name}", m, want) + f"; {s:.1f} s, "
              + row_stats(row) + f"; card: {card}", flush=True)
        if want is not None:
            check(abs(m["HOTA"] - want["HOTA"]) <= SCORE_HOTA_BAR,
                  f"(a) {name}: HOTA {m['HOTA']} against the committed "
                  f"{want['HOTA']} (bar {SCORE_HOTA_BAR})")
    scale_bars(rows)
    print(f"phase {phase} (a) the JAX package's orderings and scale bars "
          f"hold on every row; {a_s:.1f} s, the scoring "
          f"{seen['metrics_s'][0]:.1f} s of it", flush=True)

    # ---- (b) the deployed points -------------------------------------
    for name, probe, m, row in probed["points"]:
        if "emb_cadence" in probe:
            want = cadence[name][str(probe["emb_cadence"])]
            point = f"cadence {probe['emb_cadence']}"
        else:
            point = f"priority_{probe['emb_budget']}"
            want = budget[name][point]
        base = cadence[name]["1"]["HOTA"]
        print(rows_line(f"(b) {name} {point}", m, want)
              + f"; cost {rows[name]['HOTA'] - m['HOTA']:.2f} against (a)'s "
              f"every-frame row (committed {base - want['HOTA']:.2f}; "
              f"bench.py's line 1.0); " + row_stats(row) + f"; card: {card}",
              flush=True)
        check(abs(m["HOTA"] - want["HOTA"]) <= SCORE_HOTA_BAR,
              f"(b) {name} {point}: HOTA {m['HOTA']} against the committed "
              f"{want['HOTA']}")
    check(not probed["differ"], f"(b) the card's priority selection differs "
          f"from the host's at frames {probed['differ'][:10]}")
    print(f"phase {phase} (b) every frame's priority selection on the card "
          f"= the host's; {probed['split']['b']:.1f} s in the worker",
          flush=True)

    # ---- (c) the host's plain-auction rows ----------------------------
    for name in SCORE_HOST_ROWS:
        diff = {k: round(rows[name][k] - host_rows[name][k], 2) for k in keys}
        print(rows_line(f"(c) {name} card", rows[name], host_rows[name])
              + f"; card less host {diff}", flush=True)
        check(all(abs(d) <= SCORE_HOST_ATOL for d in diff.values()),
              f"(c) {name}: the card's row is off the host's by {diff}")
    print(f"phase {phase} (c) the host's rows took {host_s:.1f} s in the "
          f"worker", flush=True)

    # ---- (d) BoostTrack again, in the worker: the same rows -------------
    boost = seen["rows"][list(rows).index("boosttrack")]
    check(probed["again"] == rows["boosttrack"],
          f"(d) BoostTrack's metrics moved: {probed['again']} against "
          f"{rows['boosttrack']}")
    moved = [t + 1 for t, (x, y) in enumerate(
        zip(probed["again_row"]["outs"], boost["outs"]))
        if x.shape != y.shape or not np.array_equal(
            x.view(np.int32), y.view(np.int32))]
    check(not moved, f"(d) BoostTrack's rows moved at frames {moved[:10]}")
    print(f"phase {phase} (d) BoostTrack again on the card, in the worker "
          f"process: metrics and all {SCORE_FRAMES} frames' rows identical "
          f"bit for bit; {probed['split']['d']:.1f} s", flush=True)

    # ---- (e) the kernel on each SCORE_SOLVE_ROWS row's middle frame ------
    err = 0
    for model in SCORE_SOLVE_ROWS:
        solves = seen["solves"].get((model, middle))
        check(solves, f"(e) no solve captured in {model}'s frame {middle}")
        shapes = sorted({tuple(args[0].shape) for args in solves})
        check(all(P == 1 for P, _, _ in shapes),
              f"(e) {model}: solves of {shapes}, want one problem each")
        lane = {n: next(t for t in (1, 2, 4, 8) if n <= 32 * t)
                for _, _, n in shapes}  # the kernel's columns a lane
        layout = ", ".join(f"(1, {k}, {n}) with {lane[n]} columns a lane"
                           for _, k, n in shapes)
        err = max(err, solves_on_path(
            phase, f"{model} scoreboard frame {middle} ({layout}; P=1: "
            "the eight-warp layout)", [f"solve {i + 1}" for i in
                                       range(len(solves))], solves,
            card)["auction_err"])
    total = launches + probed["launches"]
    print(f"phase {phase} wall time {time.perf_counter() - t_phase:.1f} s: "
          f"(a) {a_s:.1f}, then waited {wait_s:.1f} for the workers; "
          f"auction launches (a) {launches}, (b) {probed['launches']} ((d)'s "
          f"comparison not counted); card: {card}", flush=True)
    return {"auction_launches": total, "auction_err": err}


def synthetic_row(name, lap, device, capture=()):
    """synthetic_benchmark.py's run_table for the one tracker ``name`` at
    its defaults with ``lap`` on ``device``, watched
    (:func:`watched_scoreboard`, which copies the kernel's inputs of each
    (model, frame) of ``capture``), in a worker process at one torch
    thread. Returns the row, its line, its record without its outputs,
    the captured solves (on the CPU), the auction kernel's launches
    (counted from 0) and the scoring's seconds."""
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.scripts.synthetic_benchmark import run_table

    torch.set_num_threads(1)
    auction_cuda.LAUNCHES = 0
    lines = []
    with watched_scoreboard(capture=capture) as seen:
        table = run_table(trackers=[name], lap=lap, device=device,
                          progress=lines.append)
    (row,) = seen["rows"]
    solves = {key: [[t.cpu() for t in args] for args in captured]
              for key, captured in seen["solves"].items()}
    return (table[name], lines[0], dict(row, outs=None), solves,
            auction_cuda.LAUNCHES, seen["metrics_s"][0])


def eval_table(stdout):
    """The eval tool's table in ``stdout``: its header to its COMBINED
    row."""
    lines = stdout.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("seq "))
    end = next(i for i, ln in enumerate(lines) if ln.startswith("COMBINED"))
    return lines[start:end + 1]


def run_group(argv, env, timeout):
    """``argv`` in a session of its own; every process of the session is
    killed if it outlives ``timeout`` seconds. Returns (exit code,
    stdout, stderr)."""
    import signal

    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise CheckFailure(f"{argv[:2]} did not end within {timeout} s")
    return proc.returncode, out, err


def evaluation_tools_phase(phase, card):
    """Phase ``phase``: the accuracy and evaluation tools of
    motcpp_tpu_torch/scripts/ on the card. (a) synthetic_benchmark.py's
    run_table at its defaults (nine trackers, 300 frames, 24 objects,
    max_tracks=64, max_dets=48) through the auction kernel, one task a
    row in a pool of SYN_WORKERS spawned processes: every row launches
    it; SYN_HOST_ROWS also run on the host through the plain auction (in
    the same pool), the card's rows within SCORE_HOST_ATOL of them on
    HOTA, MOTA, IDF1, DetA and AssA; (b) the kernel on the solves of
    ByteTrack's frame SYN_SOLVE_FRAME held to the plain auction (max abs
    err 0) and timed beside it and its bound. While the pool runs (a),
    this process runs (d)-(f): (d) run_benchmark.sh with
    TRACKERS=bytetrack CLI_FLAGS="--lap auction_pallas" over MOT17-mini
    in a subprocess: its result files equal the CLI's on the host
    (--cpu --lap auction_pallas) byte for byte and its eval_mot table
    equals eval_mot's on the host's files; (e) regen_golden.py's nine
    tests/golden sets (exact JV), regen_golden_cmc.py's botsort_sofjax
    rows, byte for byte, and regen_golden_reid.py's forward fingerprint
    with TF32 off, each value within one 1e-4 rounding step of
    tests/golden_reid/forward_fingerprint.json, and, where cv2 or PIL
    reads the MOT17-02 jpgs, its StrongSORT and BoT-SORT rows with frames
    and ids exact and values within REID_ROW_ATOL; (f)
    generate_demo_gifs.py's track_frames for ByteTrack over the 40-frame
    synthetic pan scene: ids equal to the CPU's, boxes and confidences
    within GIF_BOX_ATOL. The tune loop, (c) in the tools' list, is phase
    18 (a). Returns (a)'s kernel launches (each task's counted from 0)
    and (b)'s largest difference."""
    from motcpp_tpu_torch.appearance.reid import ReIDBackend
    from motcpp_tpu_torch.cli import main as cli_main
    from motcpp_tpu_torch.scripts import (
        eval_mot,
        generate_demo_gifs,
        regen_golden,
        regen_golden_cmc,
        regen_golden_reid,
    )
    from motcpp_tpu_torch.scripts import synthetic_benchmark as syn

    t_phase = time.perf_counter()
    keys = ("HOTA", "MOTA", "IDF1", "DetA", "AssA")
    capture = (("bytetrack", SYN_SOLVE_FRAME),)
    with ProcessPoolExecutor(
            SYN_WORKERS, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        # ---- (a) every row through the kernel, two on the host too -------
        host = {name: pool.submit(synthetic_row, name, "auction", "cpu")
                for name in SYN_HOST_ROWS}
        card_rows = {name: pool.submit(synthetic_row, name, "auction_pallas",
                                       "cuda", capture)
                     for name in sorted(syn.TRACKERS)}

        # ---- (d) run_benchmark.sh on the card against the host's CLI ------
        script = (Path(__file__).resolve().parent / "motcpp_tpu_torch"
                  / "scripts" / "run_benchmark.sh")
        with tempfile.TemporaryDirectory() as d:
            d = Path(d)
            t0 = time.perf_counter()
            rc, out, err_text = run_group(
                ["bash", str(script), str(MOT_MINI)],
                dict(os.environ, TRACKERS="bytetrack",
                     CLI_FLAGS="--lap auction_pallas",
                     OUT_BASE=str(d / "card"), PYTHON=sys.executable),
                BENCH_SH_TIMEOUT)
            d_s = time.perf_counter() - t0
            check(rc == 0,
                  f"(d) run_benchmark.sh exited {rc}: {err_text[-2000:]}")
            with contextlib.redirect_stdout(io.StringIO()):
                check(cli_main([str(MOT_MINI), str(d / "host"), "bytetrack",
                                "--cpu", "--lap", "auction_pallas"]) == 0,
                      "(d) the CLI failed on the host")
            diff = regen_golden.first_difference(d / "card" / "bytetrack",
                                                 d / "host")
            check(diff is None, f"(d) run_benchmark.sh's files differ from "
                  f"the host CLI's at {diff}")
            host_eval = io.StringIO()
            with contextlib.redirect_stdout(host_eval):
                check(eval_mot.main(["--gt_folder", str(MOT_MINI),
                                     "--trackers_folder",
                                     str(d / "host")]) == 0,
                      "(d) eval_mot failed on the host's files")
            table_d = eval_table(out)
            check(table_d == eval_table(host_eval.getvalue()),
                  "(d) run_benchmark.sh's eval table differs from the host's")
            n_rows = sum(len(f.read_text().splitlines())
                         for f in (d / "host").glob("*.txt"))
        print(f"phase {phase} (d) run_benchmark.sh TRACKERS=bytetrack "
              f"CLI_FLAGS='--lap auction_pallas' over MOT17-mini on the "
              f"card in a subprocess: result files = the host CLI's (--cpu "
              f"--lap auction_pallas) byte for byte ({n_rows} rows), eval "
              f"table = eval_mot on the host's files (combined HOTA, MOTA, "
              f"IDF1 {' '.join(table_d[-1].split()[1:4])}); {d_s:.1f} s "
              f"(the script's kernel launches are its own processes', not "
              f"counted here)", flush=True)

        # ---- (e) the regenerators on the card -----------------------------
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            for name in regen_golden.TRACKERS:
                with contextlib.redirect_stdout(io.StringIO()):
                    out_dir = regen_golden.write_set(name, "golden", Path(d),
                                                     "cuda")
                diff = regen_golden.first_difference(
                    out_dir, TESTS / "golden" / name)
                check(diff is None, f"(e) regen_golden's {name} set differs "
                      f"from tests/golden at {diff}")
        golden_s = time.perf_counter() - t0
        _, tracker, kwargs, needs_cv2 = next(
            r for r in regen_golden_cmc.RUNS if r[0] == "botsort_sofjax")
        check(not needs_cv2, "(e) botsort_sofjax is marked as needing cv2")
        t0 = time.perf_counter()
        text = regen_golden_cmc.run_scene(tracker, kwargs, "cuda")
        line = regen_golden.differing_line(
            text.encode(), (TESTS / "golden_cmc" / "botsort_sofjax.txt")
            .read_bytes())
        check(line is None, f"(e) regen_golden_cmc's botsort_sofjax rows "
              f"differ from tests/golden_cmc at line {line}")
        cmc_s = time.perf_counter() - t0
        backend = ReIDBackend(weights=str(regen_golden_reid.FIXTURE),
                              device="cuda")
        with exact_float32():
            fp = regen_golden_reid.forward_fingerprint(backend)
        want = json.loads((TESTS / "golden_reid" / "forward_fingerprint.json")
                          .read_text())
        parts = ("norms", "pairwise_cos", "first8")
        check(fp["feature_dim"] == want["feature_dim"]
              and all(len(fp[k]) == len(want[k]) for k in parts),
              f"(e) the fingerprint's shape differs: {fp}")
        steps = max(abs(round(a * 1e4) - round(b * 1e4))
                    for k in parts for a, b in zip(fp[k], want[k]))
        check(steps <= 1, f"(e) the card's fingerprint is {steps} rounding "
              f"steps off tests/golden_reid: {fp}")
        fp_line = ("identical to" if fp == want
                   else f"within {steps} rounding step of")
        # the tracker rows read the MOT17-02 jpgs, which needs cv2 or PIL
        try:
            regen_golden_reid.load_frames_and_dets()
            unread = None
        except RuntimeError as exc:
            unread = str(exc)
        if unread is None:
            reid = []
            for name in regen_golden_reid.TRACKERS:
                with exact_float32():
                    got = regen_golden_reid.run_tracker(name, backend, "cuda")
                golden = TESTS / "golden_reid" / f"{name}_MOT17-02.json"
                want_rows = json.loads(golden.read_text())
                check(len(got) == len(want_rows) and all(
                    g[0] == w[0] and g[5] == w[5]
                    and max(abs(a - b) for a, b in zip(g, w)) <= REID_ROW_ATOL
                    for g, w in zip(got, want_rows)),
                    f"(e) {name}'s ReID golden rows on the card differ from "
                    f"tests/golden_reid beyond {REID_ROW_ATOL}")
                exact = (json.dumps(got) + "\n").encode() == golden.read_bytes()
                reid.append(f"{name} {len(got)} rows "
                            + ("byte for byte" if exact else
                               f"(frames and ids exact, values within "
                               f"{REID_ROW_ATOL}; not byte for byte)"))
            rows_line = ("its tracker rows over the MOT17-02 jpgs on the card "
                         "(TF32 off): " + ", ".join(reid))
        else:
            rows_line = (f"its tracker rows over the MOT17-02 jpgs were not "
                         f"run on the card ({unread}) and are held on the CPU "
                         f"by tests/test_torch_regen.py")
        print(f"phase {phase} (e) regen_golden's nine tests/golden sets on "
              f"the card (exact JV): byte for byte, {golden_s:.1f} s; "
              f"regen_golden_cmc's botsort_sofjax: byte for byte, "
              f"{cmc_s:.1f} s; regen_golden_reid's forward fingerprint (TF32 "
              f"off) {fp_line} tests/golden_reid/forward_fingerprint.json; "
              f"{rows_line}; card: {card}", flush=True)

        # ---- (f) the GIF tool's tracking ------------------------------------
        runs = {dev: generate_demo_gifs.track_frames(
            "bytetrack", generate_demo_gifs.synthetic_frames(), dev)
            for dev in ("cuda", "cpu")}
        check(len(runs["cuda"]) == len(runs["cpu"]) == 40,
              "(f) the GIF tool did not track 40 frames")
        worst = 0.0
        for (fid, _, a), (_, _, b) in zip(runs["cuda"], runs["cpu"]):
            check(a.shape == b.shape
                  and np.array_equal(a[:, [4, 6, 7]], b[:, [4, 6, 7]]),
                  f"(f) frame {fid}: the card's ids differ from the CPU's")
            worst = max(worst,
                        float(np.abs(a[:, :6] - b[:, :6]).max(initial=0)))
        check(worst <= GIF_BOX_ATOL, f"(f) boxes {worst} off the CPU's")
        n_rows = sum(len(a) for _, _, a in runs["cuda"])
        print(f"phase {phase} (f) generate_demo_gifs.track_frames ByteTrack "
              f"over the 40-frame synthetic pan scene on the card: {n_rows} "
              f"rows, ids = the CPU's, boxes within {worst:.2e} of them; the "
              f"drawing and the GIF encoding (host work that needs cv2 or "
              f"PIL) were not run on the card and are held by "
              f"tests/test_torch_convert_gifs.py", flush=True)
        def_s = time.perf_counter() - t_phase
        card_rows = {name: run.result() for name, run in card_rows.items()}
        host = {name: run.result()[0] for name, run in host.items()}
        wait_s = time.perf_counter() - t_phase - def_s

    # ---- (a)'s rows -----------------------------------------------------------
    print(f"phase {phase} (a) {syn.HEADER}")
    launches, metrics_s, solves = 0, 0.0, {}
    for name, (got, line, row, captured, n, m_s) in card_rows.items():
        per = np.asarray(row["launches"])
        check(per.sum() > 0, f"(a) {name}: no auction kernel launch")
        launches, metrics_s = launches + n, metrics_s + m_s
        solves.update(captured)
        print(f"phase {phase} (a) {line}; {got['seconds']:.2f} s, "
              f"update() {1e3 * row['update_s'] / len(per):.2f} ms a frame, "
              f"{per.sum()} launches ({per.min()}-{per.max()} a frame); "
              f"card: {card}", flush=True)
    for name in SYN_HOST_ROWS:
        got, want = card_rows[name][0], host[name]
        diff = {k: got[k] - want[k] for k in keys}
        same = all(got[k] == want[k] for k in keys + ("IDSW",))
        print(f"phase {phase} (a) {name} card against the host's plain "
              f"auction: " + ", ".join(f"{k} {got[k]:.4f} ({want[k]:.4f})"
                                       for k in keys)
              + f", IDSW {got['IDSW']} ({want['IDSW']}); "
              + ("identical" if same else f"card less host {diff}"))
        check(all(abs(d) <= SCORE_HOST_ATOL for d in diff.values()),
              f"(a) {name}: the card's row is off the host's by {diff}")
    print(f"phase {phase} (a) the nine rows one task each in a pool of "
          f"{SYN_WORKERS} spawned processes (with the host's "
          f"{len(SYN_HOST_ROWS)}), the scoring {metrics_s:.1f} s of their "
          f"time; this process ran (d)-(f) meanwhile in {def_s:.1f} s, then "
          f"waited {wait_s:.1f} s for the pool; auction launches "
          f"{launches}", flush=True)

    # ---- (b) the kernel on ByteTrack's solves of one frame ---------------
    solves = solves.get(("bytetrack", SYN_SOLVE_FRAME))
    check(solves, f"(b) no solve captured in ByteTrack's frame "
          f"{SYN_SOLVE_FRAME}")
    solves = [[t.to("cuda") for t in args] for args in solves]
    shapes = ", ".join(str(tuple(args[0].shape)) for args in solves)
    err = solves_on_path(
        phase, f"synthetic ByteTrack frame {SYN_SOLVE_FRAME} ({shapes})",
        [f"solve {i + 1}" for i in range(len(solves))], solves,
        card)["auction_err"]
    print(f"phase {phase} wall time {time.perf_counter() - t_phase:.1f} s: "
          f"(d)-(f) {def_s:.1f} beside (a), then waited {wait_s:.1f}; "
          f"auction launches (a) {launches}; card: {card}", flush=True)
    return {"auction_launches": launches, "auction_err": err}


@contextlib.contextmanager
def recorded_example():
    """While inside, the rows each tracker wrapper's ``update()`` returns
    and the x translations of each ``sof_jax_batch`` call go into the
    dict this yields (``rows``, ``pans``), and every line printed goes
    into its ``out`` (a StringIO)."""
    import motcpp_tpu_torch
    from motcpp_tpu_torch.motion import cmc

    seen = {"rows": [], "pans": [], "out": io.StringIO()}
    create, sof = motcpp_tpu_torch.create_tracker, cmc.sof_jax_batch

    def creating(*args, **kwargs):
        tracker = create(*args, **kwargs)
        update = tracker.update

        def recorded(*a, **k):
            seen["rows"].append(update(*a, **k))
            return seen["rows"][-1]

        tracker.update = recorded
        return tracker

    def sof_recorded(prev, cur, *args, **kwargs):
        warps, ok = sof(prev, cur, *args, **kwargs)
        seen["pans"].append(warps[:, 0, 2].cpu().numpy())
        return warps, ok

    motcpp_tpu_torch.create_tracker, cmc.sof_jax_batch = creating, sof_recorded
    try:
        with contextlib.redirect_stdout(seen["out"]):
            yield seen
    finally:
        motcpp_tpu_torch.create_tracker, cmc.sof_jax_batch = create, sof


def run_example(name, argv):
    """The example ``name``'s ``main(argv)`` in this process: its lines,
    its update() rows and pans (:func:`recorded_example`) and its wall
    time in s, the card synchronised after it."""
    import importlib

    mod = importlib.import_module(f"motcpp_tpu_torch.examples.{name}")
    t0 = time.perf_counter()
    with recorded_example() as seen:
        rc = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"the {name} example exited {rc}: {argv}")
    return dict(seen, lines=seen["out"].getvalue().splitlines(), s=wall)


EXAMPLE_BOXES = re.compile(r"box=\([^)]*\)")
EXAMPLE_PANS = re.compile(r"estimated pans \[[^\]]*\]")
EXAMPLE_TIMES = re.compile(r"compile\+run +[\d.]+ ms|run +[\d.]+ ms|"
                           r"[\d,]+ aggregate FPS|backend=\w+")


def same_example_runs(label, got, want):
    """Two runs of one example print the same lines, but the boxes of
    update()'s rows (within EXAMPLE_BOX_ATOL; ids, classes and detection
    indices exact), the estimated pans (within SOF_PAN_ATOL) and
    multistream_serving's times and device type."""
    def masked(lines):
        return [EXAMPLE_TIMES.sub("<time>", EXAMPLE_PANS.sub(
            "estimated pans", EXAMPLE_BOXES.sub("box=", ln))) for ln in lines]

    check(masked(got["lines"]) == masked(want["lines"]),
          f"{label}: the lines differ: {got['lines']} against "
          f"{want['lines']}")
    check(len(got["rows"]) == len(want["rows"]),
          f"{label}: {len(got['rows'])} update() calls, want "
          f"{len(want['rows'])}")
    for a, b in zip(got["rows"], want["rows"]):
        check(a.shape == b.shape
              and np.array_equal(a[:, [4, 6, 7]], b[:, [4, 6, 7]]),
              f"{label}: update() returned other ids or rows")
        err = float(np.abs(a[:, :6] - b[:, :6]).max(initial=0))
        check(err <= EXAMPLE_BOX_ATOL,
              f"{label}: update()'s boxes {err} px apart")
    check(len(got["pans"]) == len(want["pans"]) and all(
        float(np.abs(a - b).max()) <= SOF_PAN_ATOL
        for a, b in zip(got["pans"], want["pans"])),
        f"{label}: the estimated pans differ beyond {SOF_PAN_ATOL} px")


def async_markers(label, run, streams, ticks):
    """async_serving's lines: its header, the native mux, one line a
    tick, rows served, and its verdict."""
    lines = run["lines"]
    check(lines[:2] == [f"{streams} streams over 1 device(s)",
                        "mux backend: native C++"],
          f"{label}: its header is {lines[:2]}")
    ticks_seen = [re.fullmatch(r"tick +(\d+): (\d+)/(\d+) streams present, "
                               r"(\d+) track rows", ln)
                  for ln in lines[2:2 + ticks]]
    check(all(ticks_seen) and [int(m.group(1)) for m in ticks_seen]
          == list(range(ticks)), f"{label}: its tick lines are {lines}")
    rows = sum(int(m.group(4)) for m in ticks_seen)
    served = re.match(r"served (\d+) track rows; stats: ",
                      lines[2 + ticks])
    check(served and int(served.group(1)) == rows and rows > 0,
          f"{label}: served {lines[2 + ticks]}, the ticks {rows}")
    check(lines[3 + ticks:] == ["async serving ok"],
          f"{label}: its last lines are {lines[3 + ticks:]}")
    return rows


def examples_phase(phase, card):
    """Phase ``phase``: the eight examples of motcpp_tpu_torch/examples/
    in process through their main(), at EXAMPLE_ARGS. For each: (a) on
    the card with --lap auction_pallas, the auction kernel's launches
    counted from 0 and equal to STEP_LAUNCHES of its tracker times its
    steps (EXAMPLE_STEPS); (b) with --cpu --lap auction_pallas (the
    plain auction), the same lines (:func:`same_example_runs`;
    async_serving: :func:`async_markers`); (c) at its default --lap on
    the card and with --cpu, the same lines. (d) the kernel on the solves of
    multistream_serving's frame EXAMPLE_SOLVE_FRAME held to the plain
    auction (max abs err 0) and timed beside it and its bound. Returns
    (a)'s launches and (d)'s largest difference."""
    from motcpp_tpu_torch.ops import auction_cuda

    def same_runs(label, name, card_run, host_run):
        if name != "async_serving":
            same_example_runs(label, card_run, host_run)
            return "the same lines"
        streams, ticks = map(int, EXAMPLE_ARGS[name][1::2])
        rows = [async_markers(f"{label} {where}", run, streams, ticks)
                for where, run in (("card", card_run), ("CPU", host_run))]
        return (f"the same markers, {rows[0]} rows on the card and {rows[1]} "
                f"on the CPU (its threads' timing)")

    t_phase = time.perf_counter()
    launches, per_example, solves = 0, {}, []
    for name, argv in EXAMPLE_ARGS.items():
        tracker, steps = EXAMPLE_STEPS[name]
        per_step = STEP_LAUNCHES[tracker]
        kernel = argv + ["--lap", "auction_pallas"]
        # ---- (a) on the card through the kernel -------------------------
        with contextlib.ExitStack() as stack:
            if name == "multistream_serving":  # (d)'s frame's solves
                calls, first = [0], per_step * EXAMPLE_SOLVE_FRAME

                def at_frame():
                    calls[0] += 1
                    return first < calls[0] <= first + per_step

                solves = stack.enter_context(captured_solves(at_frame))
            auction_cuda.LAUNCHES = 0
            card_run = run_example(name, kernel)
            n = auction_cuda.LAUNCHES
        check(n > 0, f"(a) {name}: no auction kernel launch")
        check(n == per_step * steps, f"(a) {name}: {n} auction kernel "
              f"launches, want {per_step} a step x {steps} steps")
        check(name != "multistream_serving" or card_run["lines"][0].endswith(
            "backend=cuda"), f"(a) {name}: {card_run['lines'][0]}")
        launches += n
        per_example[name] = n
        # ---- (b) on the CPU through the plain auction --------------------
        host_run = run_example(name, kernel + ["--cpu"])
        b_line = same_runs(f"(b) {name}", name, card_run, host_run)
        # ---- (c) at the example's default --lap -------------------------
        card_def, host_def = (run_example(name, argv),
                              run_example(name, argv + ["--cpu"]))
        c_line = same_runs(f"(c) {name}", name, card_def, host_def)
        print(f"phase {phase} (a) {name} {' '.join(kernel)} on the card: "
              f"{n} auction launches ({tracker}, {per_step} a step x {steps} "
              f"steps), {card_run['s']:.2f} s; (b) with --cpu (the plain "
              f"auction) {b_line}, {host_run['s']:.2f} s; (c) at its default "
              f"--lap {c_line} (card {card_def['s']:.2f} s, CPU "
              f"{host_def['s']:.2f} s); last line {card_run['lines'][-1]!r}; "
              f"card: {card}", flush=True)
        if name == "multistream_serving":
            print(f"phase {phase} (a) multistream_serving's lines on the "
                  f"card: " + " | ".join(card_run["lines"]), flush=True)

    # ---- (d) the kernel on one multistream_serving frame's solves ----
    shapes = ", ".join(str(tuple(args[0].shape)) for args in solves)
    err = solves_on_path(
        phase, f"multistream_serving frame {EXAMPLE_SOLVE_FRAME} ({shapes})",
        ("stage 1", "stages 2+3"), solves, card)["auction_err"]
    print(f"phase {phase} wall time {time.perf_counter() - t_phase:.1f} s: "
          f"auction launches (a) {launches} "
          + ", ".join(f"{k} {v}" for k, v in per_example.items())
          + f"; card: {card}", flush=True)
    return {"auction_launches": launches, "auction_err": err}


BENCH_ROW_LINE = re.compile(r"^# \[(\w+)\] .*launches auction (\d+), "
                            r"OSBlock (\d+)$")


def bench_phase(phase, card):
    """Phase ``phase``: the scoreboard (``motcpp_tpu_torch/bench.py``) on
    the card. (a) ``python -m motcpp_tpu_torch.bench --quick --repeats
    1`` in a fresh process, after (b)-(d) so that neither times under the
    other's load: exit 0, the nine rows with ByteTrack last, each row's
    auction launches (its ``#`` line's) STEP_LAUNCHES of its tracker a
    frame of each run, its rows in ``_build/bench_quick_torch.json``, and
    no root ``BENCH_*.json`` written or added; (b) the six capacity rows through the
    single-tracker flags in process (``--streams 1024 --max-tracks 128
    --max-dets 64|128 --objects 40|64 --metric-suffix ...``), each
    launching the kernel STEP_LAUNCHES a frame of each run, and the
    kernel on the solves of the K=128, N=128 ByteTrack row's middle frame
    against the plain auction (max abs err 0) beside its bound; (c) the
    BoT-SORT live leg at cadence 8 with ``--fused`` (6 OSBlock and 2
    auction launches a frame), its first rollout equal to the same runner
    on the same inputs with every block through ``osblock_reference``,
    and the OSBlock kernel on the blocks of the leg's third frame against
    its plain version; (d) ByteTrack's row through the kernel against
    ``--lap auction`` at EQUAL_STREAMS streams: identical masks, ids and
    boxes in the warm-up and the timed run. The launches of (a)-(c)'s
    rows count; the comparisons' do not."""
    from motcpp_tpu_torch import bench
    from motcpp_tpu_torch.appearance import osblock, osblock_cuda
    from motcpp_tpu_torch.ops import auction_cuda
    from motcpp_tpu_torch.utils.profiling import uncounted

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    jsons = {p.name: p.read_bytes() for p in root.glob("BENCH_*.json")}
    quick = bench.BUILD / bench.QUICK_JSON
    quick.unlink(missing_ok=True)
    reps = ["--repeats", str(BENCH_REPEATS)]
    launches = {"auction": 0, "OSBlock": 0}

    def row_of(label, row, report, want):
        """Checks a row's metric, value and launches, counts them."""
        runs = 1 + BENCH_REPEATS
        check(row["metric"] == f"torch_{label}_streams_at_30fps_per_chip"
              and row["value"] > 0, f"(b)-(c) bench row {row}")
        for k, n in report["launches"].items():
            check(n == want[k] * runs, f"{label}: {n} {k} kernel "
                  f"launches over {runs} runs, want {want[k] * runs}")
            launches[k] += n
        emitted = int(report["last"][1].sum())
        check(emitted > 0, f"{label}: no emission in the last run")
        times = report["times"]
        return (f"{row['value']} streams at 30 FPS, "
                f"{np.median(times) * 1e3:.3f} ms a run (runs "
                f"{[round(t * 1e3, 3) for t in times]}), {emitted} "
                f"emissions in the last run, launches "
                f"{report['launches']}")

    # (b) the six capacity rows
    solve_stats = None
    for suffix, ov in bench.CAPACITY_ROWS:
        for trk in bench.CAPACITY_TRACKERS:
            args = bench.parser().parse_args(
                ["--tracker", trk, "--streams", str(ov["streams"]),
                 "--max-tracks", str(ov["max_tracks"]), "--max-dets",
                 str(ov["max_dets"]), "--objects", str(ov["objects"]),
                 "--metric-suffix", suffix] + reps)
            report = {}
            row = bench.bench_one(trk, args, None, suffix, report=report)
            line = row_of(f"{trk}{suffix}", row, report, {
                "auction": STEP_LAUNCHES[trk] * args.frames,
                "OSBlock": 0})
            print(f"phase {phase} (b) {trk}{suffix} S={ov['streams']} "
                  f"K={ov['max_tracks']} N={ov['max_dets']} T="
                  f"{args.frames}: {line}; card: {card}", flush=True)
            if (trk, suffix) == ("bytetrack", "_K128_N128"):
                runner = report["runner"]
                dets, masks, _ = report["device_inputs"]
                half = args.frames // 2
                runner.reset()
                runner.run(dets[:half], masks[:half])
                solve_stats = auction_on_path(
                    phase, f"bench {trk}{suffix}",
                    ("stage 1", "stages 2+3"),
                    lambda: runner.run(dets[half:half + 1],
                                       masks[half:half + 1]), card)
            del report

    # (c) the live leg through the OSBlock kernel, against the same
    # runner with every block through its plain version
    args = bench.parser().parse_args(
        ["--tracker", "botsort", "--livereid", "--emb-cadence",
         str(CADENCE), "--fused"] + reps)
    report = {}
    row = bench.bench_livereid("botsort", args, report=report)
    line = row_of(f"botsort_livereid_fused_ec{CADENCE}", row, report, {
        "auction": 2 * LIVE_T, "OSBlock": 6 * LIVE_T})
    print(f"phase {phase} (c) botsort_livereid_fused_ec{CADENCE}: "
          f"{line}; card: {card}", flush=True)
    runner = report["runner"]
    dets, masks, legs = report["device_inputs"]
    fused = osblock.osblock_fused
    with uncounted():
        osblock.osblock_fused = lambda w, x: osblock.osblock_reference(
            w.folded, w.name, x, w.cout)
        try:
            runner.reset()
            plain = runner.run(dets, masks, **legs)
        finally:
            osblock.osblock_fused = fused
        emitted, _ = same_outputs(
            f"(c) the bench's live leg through the OSBlock kernel and "
            f"through osblock_reference", report["first"], plain)
        runner.reset()
        block_stats = osblock_on_path(phase, runner, dets, masks,
                                      legs["embs"])
    print(f"phase {phase} (c) live leg, OSBlock kernel = "
          f"osblock_reference in bf16: masks, ids and boxes identical "
          f"({emitted} emissions); card: {card}", flush=True)
    del report, runner, legs

    # (d) the flagship's row through the kernel against the plain
    # auction
    firsts = {}
    with uncounted():
        for lap in ("auction_pallas", "auction"):
            report = {}
            bench.bench_one("bytetrack", bench.parser().parse_args(
                ["--tracker", "bytetrack", "--streams",
                 str(EQUAL_STREAMS), "--lap", lap] + reps),
                report=report)
            firsts[lap] = (report["first"], report["last"])
    for i, run in enumerate(("warm-up", "timed run")):
        emitted, _ = same_outputs(
            f"(d) bench ByteTrack {run}, kernel against plain auction",
            firsts["auction_pallas"][i], firsts["auction"][i])
    print(f"phase {phase} (d) bench ByteTrack row on {EQUAL_STREAMS} "
          f"streams, kernel path = plain path: identical ({emitted} "
          f"emissions in the timed run)", flush=True)

    # (a) the quick scoreboard in its own process, after (b)-(d): neither
    # side times under the other's load on the card and the host
    proc = subprocess.Popen(
        [sys.executable, "-m", "motcpp_tpu_torch.bench", "--quick"] + reps,
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=BENCH_QUICK_TIMEOUT)
    except subprocess.TimeoutExpired:
        raise CheckFailure(f"(a) the quick scoreboard ran past "
                           f"{BENCH_QUICK_TIMEOUT} s") from None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"(a) the quick scoreboard exited "
          f"{proc.returncode}: {err[-2000:]}")
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    check([r["metric"] for r in rows] == [
        f"torch_{t}_streams_at_30fps_per_chip" for t in bench.ALL_TRACKERS]
        and all(r["value"] > 0 for r in rows),
        f"(a) the quick scoreboard's rows: {rows}")
    check(json.loads(quick.read_text())["rows"] == rows,
          f"(a) {quick} does not hold the printed rows")
    check({p.name: p.read_bytes() for p in root.glob("BENCH_*.json")}
          == jsons, "(a) the scoreboard wrote a root BENCH_*.json")
    counted = {}
    for ln in err.splitlines():
        m = BENCH_ROW_LINE.match(ln)
        if m:
            counted[m[1]] = (int(m[2]), int(m[3]))
    for trk in bench.ALL_TRACKERS:
        want = (STEP_LAUNCHES[trk] * bench.parser().parse_args([]).frames
                * (1 + BENCH_REPEATS))
        check(counted.get(trk) == (want, 0), f"(a) {trk}: launches "
              f"{counted.get(trk)}, want ({want}, 0)")
    quick_launches = sum(a for a, _ in counted.values())
    launches["auction"] += quick_launches
    for ln in err.splitlines():
        if ln.startswith("# ["):
            print(f"phase {phase} (a) {ln[2:]}")
    print(f"phase {phase} (a) python -m motcpp_tpu_torch.bench --quick "
          f"--repeats {BENCH_REPEATS}: exit 0, "
          + ", ".join(f"{r['metric']} {r['value']}" for r in rows)
          + f"; {quick_launches} auction launches; no root BENCH_*.json "
          f"written", flush=True)
    print(f"phase {phase} wall time {time.perf_counter() - t_phase:.1f} s; "
          f"launches: auction {launches['auction']} ((a) {quick_launches}), "
          f"OSBlock {launches['OSBlock']}; card: {card}", flush=True)
    return {"auction_launches": launches["auction"],
            "osblock_launches": launches["OSBlock"],
            "auction_err": solve_stats["auction_err"],
            "osblock_err": block_stats["max_err"]}


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", help="another auction.cu to time beside "
                        "this checkout's kernel")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: {torch.cuda.device_count()} CUDA devices visible;"
              " set CUDA_VISIBLE_DEVICES to one", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        kernels, smi = run_smoke(args.baseline)
    except CheckFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s of wall time")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),  # 1, checked above
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
