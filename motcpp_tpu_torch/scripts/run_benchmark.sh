#!/usr/bin/env bash
# One-shot accuracy benchmark over a MOT dataset, all trackers, through
# the PyTorch/CUDA port: the counterpart of the JAX package's
# scripts/run_benchmark.sh. Data must already be on disk; metrics are
# computed by the port's eval tool.
#
# Usage: motcpp_tpu_torch/scripts/run_benchmark.sh <mot_root> [det_emb_root] [model] [reid]
#
# OUT_BASE (default ./results) and TRACKERS (default: all nine) as in the
# JAX script; CLI_FLAGS is passed to the port's CLI, e.g. --cpu to run
# on the CPU, or "--lap auction_pallas" for the auction CUDA kernel
# (without --cpu the CLI runs on the CUDA device and raises without one);
# PYTHON (default python) is the interpreter that runs both tools.
set -euo pipefail

MOT_ROOT=${1:?usage: run_benchmark.sh <mot_root> [det_emb_root] [model] [reid]}
DET_EMB_ROOT=${2:-}
MODEL=${3:-}
REID=${4:-}
OUT_BASE=${OUT_BASE:-./results}
TRACKERS=${TRACKERS:-sort bytetrack ocsort deepocsort strongsort botsort boosttrack hybridsort ucmctrack}
CLI_FLAGS=${CLI_FLAGS:-}
PYTHON=${PYTHON:-python}

cd "$(dirname "$0")/../.."

for trk in $TRACKERS; do
    echo "=== $trk"
    "$PYTHON" -m motcpp_tpu_torch.cli "$MOT_ROOT" "$OUT_BASE/$trk" "$trk" \
        $DET_EMB_ROOT $MODEL $REID $CLI_FLAGS
    "$PYTHON" -m motcpp_tpu_torch.scripts.eval_mot --gt_folder "$MOT_ROOT" \
        --trackers_folder "$OUT_BASE/$trk"
done
