#!/bin/bash
# Full offline preprocessing for train/val/test with the PyTorch port's CLIs
# (the port of scripts/preprocessing.sh; run from the repository root).
set -e
ROOT=${ROOT:-data/nuScenes}
OUT=${OUT:-data/nusc_preprocessed}
python -m shasta_tpu_torch.tools.preprocess_nuscenes --dataroot $ROOT --version v1.0-trainval \
    --results ${TRAIN_DETS:-cp_train.json} --out $OUT --split train
python -m shasta_tpu_torch.tools.preprocess_nuscenes --dataroot $ROOT --version v1.0-trainval \
    --results ${VAL_DETS:-cp_val.json} --out $OUT --split val
python -m shasta_tpu_torch.tools.preprocess_nuscenes --dataroot $ROOT --version v1.0-test \
    --results ${TEST_DETS:-cp_test.json} --out $OUT --split test --no_gt
python -m shasta_tpu_torch.tools.create_data --dataroot $ROOT --version v1.0-trainval \
    --out $OUT/infos_train_10sweeps_withvelo_filter_True.pkl
python -m shasta_tpu_torch.tools.create_data --dataroot $ROOT --version v1.0-trainval \
    --out $OUT/infos_val_10sweeps_withvelo_filter_True.pkl
python -m shasta_tpu_torch.tools.create_data --dataroot $ROOT --version v1.0-test \
    --out $OUT/infos_test_10sweeps_withvelo.pkl --no_gt

# 20 Hz mode (sweep-chain tokens + 10 Hz selection + interpolated GT):
#   python -m shasta_tpu_torch.tools.preprocess_nuscenes ... --mode 20hz
