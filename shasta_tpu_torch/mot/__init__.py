"""The port of shasta_tpu/mot/: so far the CLEAR-MOT accumulator
(metrics.py) and the self-contained AMOTA (amota.py) that
tracker.runner.eval_tracking_lite scores with."""
