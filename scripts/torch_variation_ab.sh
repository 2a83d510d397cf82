#!/bin/bash
# Times the fused variation kernel of two trees of the PyTorch port on one
# card, in turns A, B, B, A: chip_smoke.variation_times (CUDA events,
# device_ms) at the GA main shape (32, 1024, 128) and its other points,
# each tree in its own process with its own src/ first on sys.path and its
# own kernel build.
#
#   bash scripts/torch_variation_ab.sh OLD_TREE [NEW_TREE]
#
# OLD_TREE and NEW_TREE are checkouts of the repository (NEW_TREE defaults
# to this one), e.g. an older commit unpacked with
#   git archive <commit> | tar -x -C checkout/parent
# Needs an NVIDIA GPU; prints each tree's "times:" lines.
set -euo pipefail
root=$(cd "$(dirname "$0")/.." && pwd)
old=$(cd "$1" && pwd)
new=$(cd "${2:-$root}" && pwd)
for tree in "$old" "$new" "$new" "$old"; do
  echo "tree: $tree"
  python3 - "$tree" <<'PY'
import sys
tree = sys.argv[1]
sys.path[:0] = [tree + "/src", tree]
import torch
import chip_smoke
import repro_torch
assert repro_torch.__file__.startswith(tree), repro_torch.__file__
chip_smoke.variation_times(torch.device("cuda", 0), chip_smoke.card_line())
PY
done
