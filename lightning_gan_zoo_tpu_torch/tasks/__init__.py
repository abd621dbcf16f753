from .base import GANTask
from .gan2d import HOLOGAN

__all__ = ["GANTask", "HOLOGAN"]
