"""Public serving surface of the port: ``ServeConfig`` + ``build_engine``."""
from . import core, engine, telemetry
from .config import ServeConfig, build_engine, resolve_model
from .core import (DEFAULT_BUCKETS, EngineDraining, Request, SchedulerCore,
                   resume_requests)
from .engine import ServeEngine
from .pages import PageError, PagePool, PrefixStore
from .telemetry import MetricsRegistry, Telemetry, Tracer

__all__ = ["ServeConfig", "build_engine", "resolve_model", "DEFAULT_BUCKETS",
           "Request", "SchedulerCore", "ServeEngine", "EngineDraining",
           "resume_requests", "PagePool", "PrefixStore", "PageError",
           "Telemetry", "Tracer", "MetricsRegistry", "telemetry", "core", "engine"]
