"""HiFi-GAN discriminators and GAN losses, for vocoder (fine-)training
(counterpart of the JAX package's ``models/hifigan_disc.py``; reference:
hifigan/models.py:137-291).

Plain kernels are trained directly: the reference's weight and spectral
norms are training-time parametrisations, left out there as here.  The
submodules carry the JAX tree's names (``disc{i}/conv{j}``,
``disc{i}/conv_post``), so ``weights.from_jax_params`` loads its trees.

The discriminators run in torch's own layouts: a period discriminator on
NCHW (B, 1, T/p, p), a scale discriminator on (B, C, T); their feature
maps come out in those layouts (the JAX package's are channels-last).
Each wrapper runs the real and the generated waveform as one batch, or,
for the generator's loss, the real one outside autograd.
"""

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from efficientspeech_tpu_torch.models.modules import (
    Conv1d, Conv2d, leaky_relu)

LRELU_SLOPE = 0.1
PERIODS = (2, 3, 5, 7, 11)
# (out, k, stride, groups, padding) of a scale discriminator's convs
SCALE_SPECS = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20),
               (256, 41, 2, 16, 20), (512, 41, 4, 16, 20),
               (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
               (1024, 5, 1, 1, 2))


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _conv1d_ncl(conv: Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on (B, C, T), without the channels-last transposes."""
    return F.conv1d(x, conv.weight, conv.bias, stride=conv.stride,
                    padding=conv.padding, dilation=conv.dilation,
                    groups=conv.groups)


class DiscriminatorP(nn.Module):
    """Period discriminator (reference: hifigan/models.py:137-170)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = _get_padding(5, 1)
        chans = (1, 32, 128, 512, 1024)
        for i in range(4):
            self.add_module(f"conv{i}", Conv2d(
                chans[i], chans[i + 1], (kernel_size, 1), (stride, 1),
                (pad, 0)))
        self.conv4 = Conv2d(1024, 1024, (kernel_size, 1), (1, 1), (2, 0))
        self.conv_post = Conv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x: torch.Tensor):
        """x (B, T) → (logits (B, L), feature maps (B, C, H, period))."""
        b, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None, :], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        x = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for i in range(5):
            x = leaky_relu(getattr(self, f"conv{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator (reference: hifigan/models.py:200-225)."""

    def __init__(self):
        super().__init__()
        c_in = 1
        for i, (ch, k, s, g, p) in enumerate(SCALE_SPECS):
            self.add_module(f"conv{i}", Conv1d(c_in, ch, k, stride=s,
                                               padding=p, groups=g))
            c_in = ch
        self.conv_post = Conv1d(c_in, 1, 3, padding=1)

    def forward(self, x: torch.Tensor):
        """x (B, T) → (logits (B, L), feature maps (B, C, L))."""
        x = x[:, None, :]
        fmap = []
        for i in range(len(SCALE_SPECS)):
            x = leaky_relu(_conv1d_ncl(getattr(self, f"conv{i}"), x),
                           LRELU_SLOPE)
            fmap.append(x)
        x = _conv1d_ncl(self.conv_post, x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def _avg_pool1d(x: torch.Tensor, kernel: int = 4, stride: int = 2,
                padding: int = 2) -> torch.Tensor:
    """torch AvgPool1d(4, 2, padding=2) with count_include_pad=True."""
    return F.avg_pool1d(x[:, None, :], kernel, stride, padding,
                        count_include_pad=True)[:, 0]


def _both(disc: nn.Module, y: torch.Tensor, y_hat: torch.Tensor,
          real_grad: bool):
    """(real logits, generated logits, real maps, generated maps) of one
    discriminator.  With ``real_grad`` the real and the generated batch
    run as one; without it the real one runs outside autograd (the
    generator's loss holds its maps constant) and the generated one
    alone."""
    if real_grad:
        b = y.shape[0]
        logits, fmap = disc(torch.cat([y, y_hat]))
        return (logits[:b], logits[b:], [f[:b] for f in fmap],
                [f[b:] for f in fmap])
    with torch.no_grad():
        real, fmap_r = disc(y)
    gen, fmap_g = disc(y_hat)
    return real, gen, fmap_r, fmap_g


class MultiPeriodDiscriminator(nn.Module):
    """(reference: hifigan/models.py:173-197)"""

    def __init__(self):
        super().__init__()
        for i, period in enumerate(PERIODS):
            self.add_module(f"disc{i}", DiscriminatorP(period))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor,
                real_grad: bool = True):
        """Lists over the periods: (real logits, generated logits, real
        feature maps, generated feature maps); ``real_grad=False`` leaves
        the real ones out of autograd."""
        outs = ([], [], [], [])
        for i in range(len(PERIODS)):
            for out, v in zip(outs, _both(getattr(self, f"disc{i}"), y,
                                          y_hat, real_grad)):
                out.append(v)
        return outs


class MultiScaleDiscriminator(nn.Module):
    """(reference: hifigan/models.py:228-257)"""

    def __init__(self):
        super().__init__()
        for i in range(3):
            self.add_module(f"disc{i}", DiscriminatorS())

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor,
                real_grad: bool = True):
        """As ``MultiPeriodDiscriminator``'s, over three scales."""
        outs = ([], [], [], [])
        for i in range(3):
            if i:
                y, y_hat = _avg_pool1d(y), _avg_pool1d(y_hat)
            for out, v in zip(outs, _both(getattr(self, f"disc{i}"), y,
                                          y_hat, real_grad)):
                out.append(v)
        return outs


# --- GAN losses (reference: hifigan/models.py:260-291) ----------------------

def feature_loss(fmap_r: List, fmap_g: List) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(real_outs: List, gen_outs: List):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(real_outs, gen_outs):
        r = torch.mean((1.0 - dr) ** 2)
        g = torch.mean(dg ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outs: List):
    loss = 0.0
    gen_losses = []
    for dg in disc_outs:
        term = torch.mean((1.0 - dg) ** 2)
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses
