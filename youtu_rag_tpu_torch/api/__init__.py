"""The HTTP/SSE API (``create_app``) over an ``ApiState``.

``create_app`` is exported lazily: only ``api/app.py`` imports tornado, so
``ApiState`` and the rest of the port import on a host without it."""

from .state import ApiState, LocalFileStore

__all__ = ["ApiState", "LocalFileStore", "create_app"]


def __getattr__(name: str):
    if name == "create_app":
        from .app import create_app

        return create_app
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
