from .tracer import DBTracingProcessor, Span, Tracer, get_tracer, setup_tracing

__all__ = ["DBTracingProcessor", "Span", "Tracer", "get_tracer", "setup_tracing"]
