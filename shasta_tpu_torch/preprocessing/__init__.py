"""Offline preprocessing, the port of shasta_tpu/preprocessing/: the
nuScenes artifact tree (data/nusc_preprocessed) that the port's CLIs read.

Mirrors the reference preprocessing chain (preprocessing.sh:1-27) with the
same on-disk formats, without the nuscenes-devkit (the raw nuScenes JSON
tables are read directly by nusc_db): nusc_db, nuscenes_chain, infos,
det_tools, stats and the GT affinity labels of training (associate,
gt_shasta). Numpy only.
"""
