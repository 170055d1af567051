"""Host-side utilities of the port (own copies; nothing imported from the
reference package)."""

from .checkpoint import (
    CheckpointManager,
    resume_engine_state,
    save_engine_state,
)
from .logging import Logger, log_msg, set_log_level

__all__ = ["CheckpointManager", "resume_engine_state", "save_engine_state",
           "Logger", "log_msg", "set_log_level"]
