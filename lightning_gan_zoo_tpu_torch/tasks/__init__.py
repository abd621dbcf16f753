from .base import GANTask
from .gan2d import DCGAN, GANStabilityR1, HOLOGAN, WGAN, WGANGP
from .nerf_gan import ANIGAN, PIGAN

__all__ = ["GANTask", "DCGAN", "GANStabilityR1", "WGAN", "WGANGP", "HOLOGAN",
           "PIGAN", "ANIGAN"]
