from tdoa_tpu.utils.constants import (
    SPEED_OF_LIGHT,
    DEFAULT_SAMPLE_RATE,
    DEFAULT_MAX_LAG,
)
from tdoa_tpu.utils.platform import select_platform, setup_compilation_cache

__all__ = [
    "SPEED_OF_LIGHT",
    "DEFAULT_SAMPLE_RATE",
    "DEFAULT_MAX_LAG",
    "select_platform",
    "setup_compilation_cache",
]
