from repro_torch.serve.cache import BlockPool, PromptBuckets, SlotPool, scatter_prompt_blocks
from repro_torch.serve.engine import (
    EXECUTION_MODES,
    SamplingConfig,
    freeze_params,
    resolve_execution_mode,
    select_token,
)
from repro_torch.serve.scheduler import (
    ADMISSION_POLICIES,
    CompletedRequest,
    Request,
    SchedulerStats,
    ServeSession,
)

__all__ = [
    "ADMISSION_POLICIES",
    "BlockPool",
    "CompletedRequest",
    "EXECUTION_MODES",
    "PromptBuckets",
    "Request",
    "SamplingConfig",
    "SchedulerStats",
    "ServeSession",
    "SlotPool",
    "freeze_params",
    "resolve_execution_mode",
    "scatter_prompt_blocks",
    "select_token",
]
