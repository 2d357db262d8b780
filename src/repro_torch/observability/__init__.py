"""Observability of the port: span tracing (``trace``) and the metrics
registry (``metrics``), with the JAX package's span and series names
(``docs/observability.md``).  Install a tracer process-wide with
:func:`set_tracer`; instrumented code (``TrainLoop``, the data loaders)
reads it via :func:`get_tracer` and pays a no-op when tracing is off."""
from repro_torch.observability.metrics import (STEP_TIME_BUCKETS_MS,  # noqa: F401
                                               MetricsRegistry)
from repro_torch.observability.trace import (NULL_TRACER, NullTracer,  # noqa: F401
                                             Tracer, get_tracer, set_tracer)

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "get_tracer", "set_tracer",
           "MetricsRegistry", "STEP_TIME_BUCKETS_MS"]
