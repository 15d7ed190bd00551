from .ops import power_project
from .ref import power_project_ref

__all__ = ["power_project", "power_project_ref"]
