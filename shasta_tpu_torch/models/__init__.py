from .affinity import AffinityNet  # noqa: F401
from .backbone import SparseBackbone  # noqa: F401
from .rpn import RPN, SharedConv  # noqa: F401
from .shasta import ShastaConfig, ShastaModel  # noqa: F401
from .vfe import voxel_mean_vfe  # noqa: F401
