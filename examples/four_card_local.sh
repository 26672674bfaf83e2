#!/usr/bin/env bash
# Four-card launch on one host — the analog of the reference's
# cori_MPI_example.sh (an MPI job, 40 iterations). One process drives all
# four cards: `--shard 2,2,1,1` splits the two scan axes over a 2x2 mesh of
# jax.devices(), halos are ppermutes that XLA hands to NCCL over NVLink,
# and the convergence scalars are psum'd, so `--stop` works as on one card.
# No launcher, scheduler glue or MPI is involved.
#
# Usage: bash examples/four_card_local.sh INPUT OUTPUT [ITERS]
#   INPUT   .emd/.h5/.dm3/.dm4/.npy 4D cube (each card reads only its own
#           shard's blocks of an .emd/.h5 file)
#   OUTPUT  .emd file written by the one process
set -euo pipefail

INPUT="${1:?usage: four_card_local.sh INPUT OUTPUT [ITERS]}"
OUTPUT="${2:?usage: four_card_local.sh INPUT OUTPUT [ITERS]}"
ITERS="${3:-40}"
REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
# the one process owns the cards; let it take 90% of each card's memory
export XLA_PYTHON_CLIENT_MEM_FRACTION="${XLA_PYTHON_CLIENT_MEM_FRACTION:-0.90}"

exec python -m cytvdn_tpu.cli \
  -i "$INPUT" \
  -o "$OUTPUT" \
  -m 1.0 \
  -n "$ITERS" \
  -f 1 \
  --shard 2,2,1,1 \
  --stop 0.05 \
  --checkpoint "${OUTPUT%.emd}.ck.npz" --checkpoint-every 10 \
  -v 1
