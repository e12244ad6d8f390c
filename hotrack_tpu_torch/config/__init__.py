from .config import get_config, overwrite_config, ensure_dirs

__all__ = ["get_config", "overwrite_config", "ensure_dirs"]
