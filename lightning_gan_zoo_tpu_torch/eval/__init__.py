"""FID/KID validation (counterpart of lightning_gan_zoo_tpu/eval/)."""
