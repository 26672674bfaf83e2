#!/usr/bin/env bash
# Local smoke test — the analog of the reference's
# local_MPI_example.sh (4 MPI ranks, 3 iterations). Runs the full CLI
# pipeline (load → sharded denoise over an 8-device mesh → EMD v0.7
# write) on a synthetic 4D cube. Works anywhere: with no accelerator attached it
# uses 8 virtual CPU devices.
#
# Usage: bash examples/local_launch.sh [workdir]
set -euo pipefail

WORK="${1:-$(mktemp -d)}"
REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
export XLA_FLAGS="--xla_force_host_platform_device_count=8 ${XLA_FLAGS:-}"

python - "$WORK" <<'PY'
import sys, numpy as np
rng = np.random.default_rng(0)
cube = (rng.standard_normal((16, 16, 12, 24)) * 0.2 + 1.0).astype(np.float32)
np.save(sys.argv[1] + "/cube.npy", cube)
PY

# the 8 virtual CPU devices stand in for cards; drop the jax_platforms
# line below to run on the GPUs
python - "$WORK" <<'PY'
import sys, jax
jax.config.update("jax_platforms", "cpu")
from cytvdn_tpu.cli import main
work = sys.argv[1]
rc = main(["-i", f"{work}/cube.npy", "-o", f"{work}/denoised.emd",
           "-m", "1.0", "-n", "3", "-f", "1", "--shard", "auto", "-v", "1"])
assert rc == 0, rc
import numpy as np
from cytvdn_tpu.io.emd import read_emd
out = read_emd(f"{work}/denoised.emd")
assert out.shape == (16, 16, 12, 24) and np.all(np.isfinite(out))
print(f"local_launch OK: wrote {work}/denoised.emd, shape {out.shape}")
PY
