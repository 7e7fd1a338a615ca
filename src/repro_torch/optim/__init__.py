from . import adamw, schedule
from .adamw import AdamWConfig, OptState
