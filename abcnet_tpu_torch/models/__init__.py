from .unet import HEAD_NAMES, PRODUCTION_HEADS, UNet, param_count
from .weights import from_flax, load_snapshot, save_snapshot, to_flax

__all__ = ["HEAD_NAMES", "PRODUCTION_HEADS", "UNet", "param_count",
           "from_flax", "load_snapshot", "save_snapshot", "to_flax"]
