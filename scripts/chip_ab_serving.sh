#!/usr/bin/env bash
# Serving A/B of two checkouts of the port on one GPU, in turns:
#
#   scripts/chip_ab_serving.sh PARENT_DIR CHANGE_DIR OUT_DIR
#
# Each directory is a full checkout (e.g. `git archive <commit> | tar -x
# -C DIR`).  The script runs chip_smoke.py's serve_moe and serve_hybrid
# phases (deepseek-moe-16b, then jamba-v0.1-52b at 16 layers, with their
# launch counts, route readings and profiles) from each checkout in the
# order parent, change, change, parent, one process each, so both sides
# share the card and the host and each runs first once.  Every run's
# JSON lines go to OUT_DIR/ab_<n>_<side>.log.  It needs one card with
# room for jamba's 52 GB and stops at the first run that fails.
set -euo pipefail
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
out=$(mkdir -p "$3" && cd "$3" && pwd)
n=0
for side in parent change change parent; do
  n=$((n + 1))
  dir=$parent
  [ "$side" = change ] && dir=$change
  (cd "$dir" && python3 - <<'PY'
import chip_smoke as cs
cs.phase_device()
cs.phase_build()
router, attn = {}, {}
cs.phase_serve_moe(router, attn)
cs.phase_serve_hybrid({"routes": {"fused": {}, "unfused": {}}}, attn, router)
PY
  ) > "$out/ab_${n}_${side}.log" 2>&1
done
