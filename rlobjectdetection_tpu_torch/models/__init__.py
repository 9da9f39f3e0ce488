from .faster_rcnn import FasterRCNN

__all__ = ["FasterRCNN"]
