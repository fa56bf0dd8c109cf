from .metadata import MetadataSchema, MISSING_I32
from .filters import CompiledFilter, compile_filter, FilterError
from .device_index import DeviceVectorIndex
from .convert import index_from_numpy

__all__ = [
    "CompiledFilter",
    "DeviceVectorIndex",
    "FilterError",
    "MISSING_I32",
    "MetadataSchema",
    "compile_filter",
    "index_from_numpy",
]
