"""Public serving surface of the port: ``ServeConfig`` + ``build_engine``,
the engines (single device, mesh, multi-process) and the front door
(``ServeService``, ``HttpFrontend``) as the reference exports them."""
from . import core, engine, telemetry
from .config import ServeConfig, build_engine, resolve_model
from .core import (DEFAULT_BUCKETS, EngineDraining, Request, SchedulerCore,
                   resume_requests)
from .engine import ServeEngine
from .frontend import HttpFrontend
from .multihost import CoordinatorAbort, MultiHostServeEngine, ProtocolError
from .pages import PageError, PagePool, PrefixStore
from .service import OverloadedError, ServeService, TokenStream
from .sharded import ShardedServeEngine
from .telemetry import MetricsRegistry, Telemetry, Tracer

__all__ = ["ServeConfig", "build_engine", "resolve_model", "DEFAULT_BUCKETS",
           "Request", "SchedulerCore", "ServeEngine", "ShardedServeEngine",
           "MultiHostServeEngine", "ProtocolError", "CoordinatorAbort", "EngineDraining",
           "OverloadedError", "resume_requests", "PagePool", "PrefixStore", "PageError",
           "ServeService", "TokenStream", "HttpFrontend",
           "Telemetry", "Tracer", "MetricsRegistry", "telemetry", "core", "engine"]
