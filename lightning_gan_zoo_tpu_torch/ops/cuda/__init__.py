"""Hand-written CUDA kernels (sources in ``csrc/``), bound with ctypes.

Importing this package registers the kernels as ``torch.library`` custom
ops (``lgzt::trilinear_{fwd,bwd}``, ``lgzt::siren_trunk_{fwd,bwd}``,
``lgzt::siren_head_{fwd,bwd}``), which ``torch.export.load`` needs for a
program that holds them. Nothing is built at import: the library is
compiled at the first launch."""
from . import siren_head, siren_trunk, trilinear  # noqa: F401  (the ops)
