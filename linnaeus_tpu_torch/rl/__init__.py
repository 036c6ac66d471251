"""Phase-2 abstention fine-tuning with PPO (port of linnaeus_tpu/rl/)."""

from .env import TaxonomicClassificationEnv  # noqa: F401
from .policies import LinnaeusPolicyWrapper, sample_actions  # noqa: F401
from .ppo import (  # noqa: F401
    PPOConfig,
    compute_gae_and_returns,
    make_ppo_update,
    train_abstention_ppo,
)
from .provider import LinnaeusRLProblemProvider  # noqa: F401
from .rewards import EpisodeOutcomeReward, SimpleAbstentionReward  # noqa: F401
from .verifier import TaxonomicRLVerifier  # noqa: F401
