"""lightning_gan_zoo_tpu_torch — the PyTorch / CUDA port of the GAN zoo.

A second package beside ``lightning_gan_zoo_tpu`` (the JAX reference). It
keeps that package's directory layout and module names, so each module's
counterpart is found under the same path. It imports ``torch`` and never
``jax``, ``flax``, ``optax``, ``orbax`` or ``lightning_gan_zoo_tpu``. The
hand-written Hopper kernels live in ``csrc/`` and are bound under
``ops/cuda/``.
"""

__version__ = "0.1.0"
