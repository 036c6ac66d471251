from .early_stop import EarlyStopState  # noqa: F401
from .ops_schedule import OpsSchedule  # noqa: F401
from .training_progress import TrainingProgress, TrainingStage  # noqa: F401
