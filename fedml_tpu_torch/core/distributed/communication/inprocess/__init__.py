"""The in-process transport."""

from .inproc_comm_manager import InProcCommManager, InProcHub

__all__ = ["InProcCommManager", "InProcHub"]
