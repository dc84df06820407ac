#!/bin/bash
# 7x per-class eval on the TEST split -> merge -> final 7-class tracking
# submission on the card with the PyTorch port (the port of
# scripts/official_test.sh: official_val.sh with --split test / v1.0-test;
# run from the repository root; .pth checkpoints).
set -e
EPOCH=${EPOCH:-3}
for c in car ped truck trailer bus motorcycle bicycle; do
  python -m shasta_tpu_torch.tools.eval --config configs/nusc/$c.py \
      --checkpoint work_dirs/$c/epoch_$EPOCH.pth \
      --work_dir work_dirs/${c}_test --split test
done
python -m shasta_tpu_torch.tools.merge_results --inputs work_dirs/*_test/cp_test.json \
    --output work_dirs/merged/cp_test.json
python -m shasta_tpu_torch.tools.pub_test --predictions work_dirs/merged/cp_test.json \
    --frame_info data/nusc_preprocessed/test_frame_info.json \
    --work_dir work_dirs/pub_test_submission "$@"
