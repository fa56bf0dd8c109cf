"""Integrations: the deep-table-reasoning Excel agent (``dtr/``)."""
