from .tracer import Span, Tracer, get_tracer

__all__ = ["Span", "Tracer", "get_tracer"]
