"""Core of the port: l_p distance sketching (Ping Li, 2008).

  registry:       EstimatorSpec, PDomain, resolve — the estimator table
  decomposition:  lp_coefficients, interaction_orders, exact_lp_distance,
                  exact_pairwise_lp, power_moments, marginal_norm, mixed_moment
  projections:    ProjectionSpec, ProjectionKey, projection_block,
                  projection_matrix
  sketch:         SketchConfig, LpSketch, sketch, sketch_moments
  estimators:     estimate, estimate_margin_mle, margin_mle_root
  pairwise:       pack_sketch, pairwise_distances, pairwise_margin_mle, knn
"""

from . import registry
from .decomposition import (
    exact_lp_distance,
    exact_pairwise_lp,
    interaction_orders,
    lp_coefficients,
    marginal_norm,
    mixed_moment,
    power_moments,
)
from .estimators import estimate, estimate_margin_mle, margin_mle_root
from .pairwise import knn, pack_sketch, pairwise_distances, pairwise_margin_mle
from .projections import (
    ProjectionKey,
    ProjectionSpec,
    fourth_moment,
    projection_block,
    projection_matrix,
)
from .registry import EstimatorSpec, PDomain, resolve
from .sketch import LpSketch, SketchConfig, sketch, sketch_moments

__all__ = [
    "registry", "EstimatorSpec", "PDomain", "resolve",
    "lp_coefficients", "interaction_orders", "exact_lp_distance",
    "exact_pairwise_lp", "power_moments", "marginal_norm", "mixed_moment",
    "ProjectionSpec", "ProjectionKey", "fourth_moment", "projection_block",
    "projection_matrix", "SketchConfig", "LpSketch", "sketch",
    "sketch_moments", "estimate", "estimate_margin_mle", "margin_mle_root",
    "pack_sketch", "pairwise_distances", "pairwise_margin_mle", "knn",
]
