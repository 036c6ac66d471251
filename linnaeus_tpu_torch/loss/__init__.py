"""Per-sample losses, null masking, class weighting and the hierarchical
multi-task loss."""

from .basic import (  # noqa: F401
    cross_entropy,
    label_smoothing_cross_entropy,
    soft_target_cross_entropy,
    taxonomy_smoothed_cross_entropy,
)
from .gradnorm import (  # noqa: F401
    GradNormState,
    gradnorm_weight_update,
    init_gradnorm_state,
    make_gradnorm_update_fn,
)
from .hierarchical import compute_core_loss, weighted_hierarchical_loss  # noqa: F401
from .masking import (  # noqa: F401
    apply_class_weighting,
    apply_loss_masking,
    apply_null_masking,
)
from .taxonomy_smoothing import build_taxonomy_smoothing_matrix  # noqa: F401
from .utils import calculate_class_weights, prepare_loss_functions  # noqa: F401
