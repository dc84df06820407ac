from .affinity import AffinityNet  # noqa: F401
from .backbone import SparseBackbone  # noqa: F401
from .bevmap import BEVMap  # noqa: F401
from .dsvt import DSVT  # noqa: F401
from .dynamic_voxel import dynamic_voxelize, dynamic_voxelize_virtual  # noqa: F401
from .rpn import RPN, ResNeck, SharedConv  # noqa: F401
from .shasta import ShastaConfig, ShastaModel  # noqa: F401
from .vfe import voxel_mean_vfe  # noqa: F401
