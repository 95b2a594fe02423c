"""EfficientSpeech on PyTorch and CUDA: the port of ``efficientspeech_tpu``.

Text → phonemes → mel → waveform inference on one NVIDIA H100, with the
folded HiFi-GAN's windowed matmuls and whole-stage MRF blocks running in
hand-written CUDA kernels (``csrc/``), and acoustic-model training
(``training/``), with the mel decoder's LayerNorms and block bodies in
two more kernels, forward and backward.  The package imports ``torch``
and never JAX; it keeps its own copies of what it shares with the JAX
package.
"""

from efficientspeech_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
