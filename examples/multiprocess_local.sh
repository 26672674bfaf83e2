#!/usr/bin/env bash
# True multi-process smoke test — 2 Python processes x 4 virtual CPU
# devices joined by jax.distributed over localhost (gloo), the same code
# path a multi-host GPU cluster takes. The closest analog of the
# reference's local_MPI_example.sh, but it additionally verifies the
# result bit-matches a single-process run, and exercises a
# kill-mid-run + checkpoint-resume cycle (the reference restarts a
# crashed job from scratch, SURVEY.md §5).
#
# Usage: bash examples/multiprocess_local.sh
set -euo pipefail

REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

python "$REPO/tools/multiproc_e2e.py"
python "$REPO/tools/multiproc_e2e.py" --checkpoint
