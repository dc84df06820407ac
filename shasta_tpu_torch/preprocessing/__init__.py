"""The GT affinity labels of training (the port of the JAX package's
preprocessing/associate.py, gt_shasta.py and nuscenes_chain._mot_rows):
numpy only. The rest of the JAX offline chain is not ported."""
