from .faster_rcnn import FasterRCNN
from .fpn import FPNFasterRCNN, build_detector
from .losses import smooth_l1_loss, softmax_cross_entropy
from .targets import anchor_target, proposal_target, uniform_source

__all__ = ["FasterRCNN", "FPNFasterRCNN", "build_detector", "anchor_target", "proposal_target", "smooth_l1_loss",
           "softmax_cross_entropy", "uniform_source"]
