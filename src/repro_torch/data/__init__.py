from . import corruptions, pipeline
from .pipeline import DataConfig, Prefetcher, make_source
