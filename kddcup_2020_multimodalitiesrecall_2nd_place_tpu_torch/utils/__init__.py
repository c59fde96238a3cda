from .cache import enable_persistent_compile_cache
from .observability import Meter, device_profile, log_metrics

__all__ = ["Meter", "device_profile", "enable_persistent_compile_cache", "log_metrics"]
