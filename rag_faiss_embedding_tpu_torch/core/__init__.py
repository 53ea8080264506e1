from .config import Config, get_config, set_config
from .logging import get_logger
