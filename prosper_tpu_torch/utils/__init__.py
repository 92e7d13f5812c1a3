"""Host utilities (counterpart of prosper_tpu/utils): the logger, the
wall-clock timer, the frame profiler and the launch count."""

from .logger import log_error, log_info, log_warn
from .timer import Timer
