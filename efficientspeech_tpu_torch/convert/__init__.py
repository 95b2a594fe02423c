"""Reference-format checkpoints: the Lightning ``.ckpt`` and HiFi-GAN
generator files of the reference implementation, read into and written
from the JAX-layout parameter tree that ``weights.py`` bridges."""
