from .lbvh import BVH, build  # noqa: F401
from .traverse import Hit  # noqa: F401
from .intersect import Accel, any_hit, closest_hit, device_accel  # noqa: F401
