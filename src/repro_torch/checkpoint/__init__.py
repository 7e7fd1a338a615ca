from . import io, manager
from .manager import CheckpointManager
