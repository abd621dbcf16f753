from .node import Config, MISSING, MissingMandatoryValue, merge, resolve_interpolations
from .compose import Composer, compose, ComposeError
from .registry import register, resolve, instantiate, RegistryError

__all__ = [
    "Config", "MISSING", "MissingMandatoryValue", "merge",
    "resolve_interpolations", "Composer", "compose", "ComposeError",
    "register", "resolve", "instantiate", "RegistryError",
]
