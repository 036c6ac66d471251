from .chain_accuracy import chain_accuracy_counts  # noqa: F401
from .step_logger import StepMetricsLogger, initialize_wandb  # noqa: F401
from .tracker import AverageMeter, MetricsTracker  # noqa: F401
