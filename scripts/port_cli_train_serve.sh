#!/usr/bin/env bash
# Trains highres128 with the port's CLI on the card (synthetic data, a few
# steps, runtime.megablock=off: the flash and LN->MLP kernels; chip_smoke.py
# trains the default 'auto' route through the megablock's training kernels),
# then serves the run directory it wrote with `cli serve`
# on a free port and sends one seeded npy request.  Run from the repository
# root:
#   bash scripts/port_cli_train_serve.sh [steps]
set -euo pipefail
steps=${1:-10}
run=build/cli_train_run
rm -rf "$run"
python -m vitgan_tpu_torch.cli train --preset highres128 --dataset synthetic --epochs 1 \
  --run-dir "$run" --set runtime.megablock=off --set data.synthetic_samples=$((32 * steps)) \
  --set run.steps_per_epoch="$steps" --set run.log_every_steps=5 2>&1 | tail -4
log="$run/serve.log"
python -u -m vitgan_tpu_torch.cli serve --run-dir "$run" --port 0 --batch 8 >"$log" 2>&1 &
pid=$!
trap 'kill $pid 2>/dev/null; wait $pid 2>/dev/null || true' EXIT
SERVE_LOG="$log" python - <<'PY'
import io, json, os, re, time, urllib.request

import numpy as np

url = None
for _ in range(240):  # the server prints its bound address once it is warm
    with open(os.environ["SERVE_LOG"]) as f:
        m = re.search(r"on (http://[\d.]+:\d+) ", f.read())
    if m:
        url = m.group(1)
        break
    time.sleep(0.5)
assert url, "cli serve printed no address"
with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
    print("healthz", json.loads(r.read()))
req = urllib.request.Request(url + "/sample",
                             data=json.dumps({"n": 4, "seed": 1, "format": "npy"}).encode(),
                             headers={"Content-Type": "application/json"})
with urllib.request.urlopen(req, timeout=120) as r:
    arr = np.load(io.BytesIO(r.read()))
assert arr.shape == (4, 128, 128, 3) and np.isfinite(arr).all(), arr.shape
print("cli serve at", url, "answered POST /sample n=4:", arr.shape, "std", float(arr.std()))
PY
