from .unet import HEAD_NAMES, PRODUCTION_HEADS, UNet, param_count
from .unet_cbam import UNetCBAM
from .unet_s2d import UNetS2D, space_to_depth
from .weights import (from_flax, load_snapshot, load_weights,
                      model_for_tree, save_snapshot, to_flax)

__all__ = ["HEAD_NAMES", "PRODUCTION_HEADS", "UNet", "UNetCBAM", "UNetS2D",
           "param_count", "space_to_depth", "from_flax", "load_snapshot",
           "load_weights", "model_for_tree", "save_snapshot", "to_flax"]
