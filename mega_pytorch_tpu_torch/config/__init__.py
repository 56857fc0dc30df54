from .defaults import cfg, get_default_cfg, BBOX_XFORM_CLIP
from .node import ConfigNode
from .presets import PRESETS, get_preset

__all__ = [
    "cfg",
    "get_default_cfg",
    "ConfigNode",
    "BBOX_XFORM_CLIP",
    "PRESETS",
    "get_preset",
]
