"""AprilGrid detection: threshold kernel -> native quads -> refine + decode."""

from .detector import TagDetector
from .families import FAMILY_NAMES, TagFamily, get_family

__all__ = ["TagDetector", "TagFamily", "get_family", "FAMILY_NAMES"]
