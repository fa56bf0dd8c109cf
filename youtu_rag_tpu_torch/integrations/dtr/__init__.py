"""Deep table reasoning over spreadsheets: the port's copy of
``youtu_rag_tpu/integrations/dtr/``."""

from .excel_agent import ExcelAgent
from .framework import DTRFramework

__all__ = ["ExcelAgent", "DTRFramework"]
