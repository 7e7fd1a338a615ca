from .api import ModelBundle, build_model, resolve_device
from .config import ArchConfig, reduced

__all__ = ["ArchConfig", "ModelBundle", "build_model", "reduced",
           "resolve_device"]
