"""Built-in experiment presets (a copy of ``mega_pytorch_tpu/config/presets.py``).

The reference composes yaml fragments: a world-size base (configs/BASE_RCNN_{N}gpu.yaml)
stacked with a per-method yaml (configs/{MEGA,RDN,FGFA,DFF}/...). We express the same
hyperparameter stacks programmatically; ``ConfigNode.merge_from_file`` still accepts
reference-style yamls for users who carry their own.

Values follow the reference configs exactly (ImageNet VID recipe):
anchors (64,128,256,512), pre/post NMS 6000/300, 128 ROI batch, 31 classes,
res5 dilation 2, min/max size 600/1000, SGD 1e-3 with 500-iter warmup.
"""

from __future__ import annotations

from .defaults import get_default_cfg
from .node import ConfigNode

# batch-size-dependent solver schedule, keyed by total images/batch
# (reference scales LR/schedule with world size: BASE_RCNN_{1,4,8}gpu.yaml)
_SOLVER_BY_BATCH = {
    1: dict(BASE_LR=0.001, STEPS=(80000,), MAX_ITER=120000),
    4: dict(BASE_LR=0.001, STEPS=(80000,), MAX_ITER=120000),
    8: dict(BASE_LR=0.002, STEPS=(40000,), MAX_ITER=60000),
}


def vid_base_cfg(ims_per_batch: int = 1) -> ConfigNode:
    """The shared VID recipe (reference BASE_RCNN_*gpu.yaml)."""
    cfg = get_default_cfg()
    cfg.MODEL.VID.ENABLE = True
    cfg.MODEL.RPN.ANCHOR_SIZES = (64, 128, 256, 512)
    cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 6000
    cfg.MODEL.RPN.PRE_NMS_TOP_N_TEST = 6000
    cfg.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 300
    cfg.MODEL.RPN.POST_NMS_TOP_N_TEST = 300
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 128
    cfg.MODEL.ROI_HEADS.SCORE_THRESH = 0.001
    cfg.MODEL.ROI_HEADS.NMS = 0.5
    cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = 300
    cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 31
    cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    cfg.MODEL.RESNETS.RES5_DILATION = 2
    cfg.INPUT.MIN_SIZE_TRAIN = (600,)
    cfg.INPUT.MAX_SIZE_TRAIN = 1000
    cfg.INPUT.MIN_SIZE_TEST = 600
    cfg.INPUT.MAX_SIZE_TEST = 1000
    cfg.DATASETS.TRAIN = ("DET_train_30classes", "VID_train_15frames")
    cfg.DATASETS.TEST = ("VID_val_frames",)
    sched = _SOLVER_BY_BATCH.get(ims_per_batch, _SOLVER_BY_BATCH[1])
    cfg.SOLVER.BASE_LR = sched["BASE_LR"]
    cfg.SOLVER.STEPS = sched["STEPS"]
    cfg.SOLVER.MAX_ITER = sched["MAX_ITER"]
    cfg.SOLVER.WEIGHT_DECAY = 0.0001
    cfg.SOLVER.WARMUP_ITERS = 500
    cfg.SOLVER.IMS_PER_BATCH = ims_per_batch
    cfg.TEST.IMS_PER_BATCH = max(ims_per_batch, 1)
    cfg.TEST.DETECTIONS_PER_IMG = 300
    return cfg


def _apply_backbone(cfg: ConfigNode, backbone: str) -> None:
    assert backbone in ("R-50", "R-101"), backbone
    cfg.MODEL.BACKBONE.CONV_BODY = f"{backbone}-C4"
    cfg.MODEL.WEIGHT = f"catalog://ImageNetPretrained/MSRA/{backbone}"
    cfg.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR = "ResNetConv52MLPFeatureExtractor"
    cfg.MODEL.ROI_BOX_HEAD.PREDICTOR = "FPNPredictor"
    if backbone == "R-50":
        cfg.MODEL.VID.ROI_BOX_HEAD.REDUCE_CHANNEL = True


def base_cfg(backbone: str = "R-50", ims_per_batch: int = 1) -> ConfigNode:
    """Single-frame Faster R-CNN baseline (configs/vid_R_{50,101}_C4_1x.yaml)."""
    cfg = vid_base_cfg(ims_per_batch)
    _apply_backbone(cfg, backbone)
    cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    return cfg


def dff_cfg(backbone: str = "R-101", ims_per_batch: int = 1) -> ConfigNode:
    cfg = vid_base_cfg(ims_per_batch)
    _apply_backbone(cfg, backbone)
    cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNNDFF"
    cfg.MODEL.VID.METHOD = "dff"
    cfg.DATASETS.TEST = ("VID_val_videos",)
    return cfg


def fgfa_cfg(backbone: str = "R-101", ims_per_batch: int = 1) -> ConfigNode:
    cfg = vid_base_cfg(ims_per_batch)
    _apply_backbone(cfg, backbone)
    cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNNFGFA"
    cfg.MODEL.VID.METHOD = "fgfa"
    cfg.DATASETS.TEST = ("VID_val_videos",)
    return cfg


def rdn_base_cfg(backbone: str = "R-101", ims_per_batch: int = 1) -> ConfigNode:
    cfg = vid_base_cfg(ims_per_batch)
    _apply_backbone(cfg, backbone)
    cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNNRDN"
    cfg.MODEL.VID.METHOD = "rdn"
    cfg.MODEL.VID.ROI_BOX_HEAD.ATTENTION.ENABLE = True
    cfg.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR = "RDNFeatureExtractor"
    cfg.DATASETS.TEST = ("VID_val_videos",)
    return cfg


def rdn_cfg(backbone: str = "R-101", ims_per_batch: int = 4) -> ConfigNode:
    """RDN stage 2: advanced distillation stage, fine-tuned from RDN-base."""
    cfg = rdn_base_cfg(backbone, ims_per_batch)
    cfg.MODEL.VID.IGNORE = True
    cfg.MODEL.VID.ROI_BOX_HEAD.ATTENTION.ADVANCED_STAGE = 1
    cfg.MODEL.WEIGHT = f"models/RDN_base_{backbone.replace('-', '_')}.pth"
    cfg.SOLVER.BASE_LR = 0.001
    cfg.SOLVER.STEPS = (40000,)
    cfg.SOLVER.MAX_ITER = 60000
    return cfg


def mega_cfg(backbone: str = "R-101", ims_per_batch: int = 1) -> ConfigNode:
    cfg = vid_base_cfg(ims_per_batch)
    _apply_backbone(cfg, backbone)
    cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNNMEGA"
    cfg.MODEL.VID.METHOD = "mega"
    cfg.MODEL.VID.ROI_BOX_HEAD.ATTENTION.ENABLE = True
    cfg.MODEL.VID.ROI_BOX_HEAD.ATTENTION.STAGE = 3
    cfg.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR = "MEGAFeatureExtractor"
    cfg.DATASETS.TEST = ("VID_val_videos",)
    if backbone == "R-50":
        cfg.MODEL.VID.MEGA.GLOBAL.RES_STAGE = 0
    return cfg


PRESETS = {
    "base_R_50": lambda: base_cfg("R-50"),
    "base_R_101": lambda: base_cfg("R-101"),
    "dff_R_50": lambda: dff_cfg("R-50"),
    "dff_R_101": lambda: dff_cfg("R-101"),
    "fgfa_R_50": lambda: fgfa_cfg("R-50"),
    "fgfa_R_101": lambda: fgfa_cfg("R-101"),
    "rdn_base_R_50": lambda: rdn_base_cfg("R-50"),
    "rdn_base_R_101": lambda: rdn_base_cfg("R-101"),
    "rdn_R_101": lambda: rdn_cfg("R-101"),
    "mega_R_50": lambda: mega_cfg("R-50"),
    "mega_R_101": lambda: mega_cfg("R-101"),
}


def get_preset(name: str) -> ConfigNode:
    return PRESETS[name]()
