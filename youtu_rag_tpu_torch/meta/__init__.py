from .generators import SimpleAgentGenerator, ToolDebugger, ToolGenerator

__all__ = ["SimpleAgentGenerator", "ToolDebugger", "ToolGenerator"]
