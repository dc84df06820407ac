#!/bin/bash
# Train all 7 per-class models on the card with the PyTorch port (the port
# of scripts/trainval.sh; run from the repository root). Each epoch writes
# work_dirs/$c/epoch_N.pth. Data parallelism over cards: see
# shasta_tpu_torch/parallel/dist.py.
set -e
for c in car ped truck trailer bus motorcycle bicycle; do
  python -m shasta_tpu_torch.tools.train --config configs/nusc/$c.py --work_dir work_dirs/$c "$@"
done
