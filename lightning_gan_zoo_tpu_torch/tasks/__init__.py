from .base import GANTask
from .gan2d import HOLOGAN
from .nerf_gan import PIGAN

__all__ = ["GANTask", "HOLOGAN", "PIGAN"]
