"""The full model's parameter container: ``phoneme2mel`` (the acoustic
model) and ``hifigan`` (the vocoder), the two subtrees of the JAX
package's parameter tree.  Inference composes them in ``infer.py``."""

from torch import nn

from efficientspeech_tpu_torch.config import HifiGanConfig, ModelConfig
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel


class EfficientSpeech(nn.Module):
    def __init__(self, cfg: ModelConfig, hifigan_cfg: HifiGanConfig):
        super().__init__()
        self.cfg = cfg
        self.hifigan_cfg = hifigan_cfg
        self.phoneme2mel = Phoneme2Mel(cfg)
        self.hifigan = HifiGanGenerator(hifigan_cfg)
