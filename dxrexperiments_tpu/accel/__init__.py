from . import bvh  # noqa: F401
from . import traverse  # noqa: F401
from .bvh import build_bvh, build_bvh_device, choose_layout  # noqa: F401
