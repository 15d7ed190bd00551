from .ops import pairwise_lp
from .ref import pairwise_lp_ref

__all__ = ["pairwise_lp", "pairwise_lp_ref"]
