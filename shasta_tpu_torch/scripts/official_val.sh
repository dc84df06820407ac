#!/bin/bash
# 7x per-class eval -> merge -> final 7-class tracking + official scoring on
# the card with the PyTorch port (the port of scripts/official_val.sh; run
# from the repository root; .pth checkpoints).
set -e
EPOCH=${EPOCH:-3}
for c in car ped truck trailer bus motorcycle bicycle; do
  python -m shasta_tpu_torch.tools.eval --config configs/nusc/$c.py \
      --checkpoint work_dirs/$c/epoch_$EPOCH.pth \
      --work_dir work_dirs/${c}_eval --split val
done
python -m shasta_tpu_torch.tools.merge_results --inputs work_dirs/*_eval/cp_val.json \
    --output work_dirs/merged/cp_val.json
python -m shasta_tpu_torch.tools.pub_test --predictions work_dirs/merged/cp_val.json \
    --frame_info data/nusc_preprocessed/val_frame_info.json \
    --work_dir work_dirs/pub_test "$@"

# Fast alternative: single-pass shared-trunk 7-class serving on the card
# (one trunk pass per frame):
#   python -m shasta_tpu_torch.tools.track_multiclass \
#       --checkpoints 'work_dirs/{cls}/epoch_'$EPOCH'.pth' \
#       --out work_dirs/multiclass/tracking_result.json
