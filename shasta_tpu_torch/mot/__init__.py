"""The port of shasta_tpu/mot/: the classical 3D-MOT library (SimpleTrack's
mot_3d/ equivalent: boxes, Kalman models, life cycle, association,
redundancy and the MOTModel driver), the CLEAR-MOT accumulator
(metrics.py) and the self-contained AMOTA (amota.py) that
tracker.runner.eval_tracking_lite scores with. Host-side numpy; the iou/giou
matrices of association and redundancy run in f32 on the model's device.
"""
from .bbox import MotBBox  # noqa: F401
from .covariance import NuCovariance  # noqa: F401
from .kalman import KalmanFilterMotionModel  # noqa: F401
from .hit_manager import HitManager  # noqa: F401
from .tracklet import Tracklet  # noqa: F401
from .association import associate_dets_to_tracks  # noqa: F401
from .mot_model import MOTModel, FrameData, UpdateInfoData  # noqa: F401
from .validity import Validity  # noqa: F401
