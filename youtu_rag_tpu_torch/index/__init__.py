from .metadata import MetadataSchema, MISSING_I32
from .filters import CompiledFilter, compile_filter, FilterError
from .device_index import DeviceVectorIndex
from .convert import index_from_numpy
from .persistence import BuildManifest, load_index, save_index

__all__ = [
    "BuildManifest",
    "CompiledFilter",
    "DeviceVectorIndex",
    "FilterError",
    "MISSING_I32",
    "MetadataSchema",
    "compile_filter",
    "index_from_numpy",
    "load_index",
    "save_index",
]
