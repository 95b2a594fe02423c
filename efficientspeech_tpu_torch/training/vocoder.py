"""HiFi-GAN vocoder (fine-)training: generator and MPD/MSD adversarial
steps (counterpart of the JAX package's ``training/vocoder.py``).

The objective is HiFi-GAN's: LSGAN adversarial terms, feature matching
and 45·mel L1, with an optional multi-resolution STFT term.  Both
optimizers are AdamW(2e-4, β = (0.8, 0.99), eps 1e-8, weight decay 0.01)
at a constant rate, as the JAX trainer runs them.

Everything is float32, as the JAX package trains its vocoder (its
generator, discriminators and convolutions are all float32); on the card
the callers keep TF32 off (``device.set_full_f32``).  A step's metrics
stay on the device.

On a data-parallel ``mesh`` each rank runs its rows of the global batch.
Every loss is a mean over the batch, so the global loss is the mean of
the ranks' equal-sized shares: after each ``torch.autograd.grad`` (the
discriminators' before their step, the generator's before its) the
gradients are averaged over the data group in one all-reduce, and so
are the metrics.  ``autograd.grad`` bypasses ``DistributedDataParallel``'s
hooks, so the models are not wrapped in it.
"""

import dataclasses
import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from efficientspeech_tpu_torch.audio.mel import mel_filterbank
from efficientspeech_tpu_torch.audio.stft import stft_magnitude
from efficientspeech_tpu_torch.config import AudioConfig, HifiGanConfig
from efficientspeech_tpu_torch.device import resolve_device
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.models.hifigan_disc import (
    MultiPeriodDiscriminator, MultiScaleDiscriminator, discriminator_loss,
    feature_loss, generator_loss)
from efficientspeech_tpu_torch.parallel.comm import (
    group_size, reduce_metrics, sum_gradients)
from efficientspeech_tpu_torch.parallel.mesh import Mesh
from efficientspeech_tpu_torch.weights import init_params, load_jax_params

# (n_fft, hop, win): the conventional multi-resolution STFT triple
# (Parallel WaveGAN recipe); eval/vocoder_eval.py scores the same set
STFT_RESOLUTIONS: Tuple[Tuple[int, int, int], ...] = (
    (512, 128, 512), (1024, 256, 1024), (2048, 512, 2048))


def multi_resolution_stft_loss(y_hat: torch.Tensor, y: torch.Tensor,
                               resolutions=STFT_RESOLUTIONS):
    """Spectral convergence + log-magnitude L1 over the resolution set:
    the auxiliary loss that pins the full-resolution magnitudes, which the
    GAN objective leaves free.  Returns (loss, per-part dict)."""
    sc_sum = 0.0
    lm_sum = 0.0
    for n_fft, hop, win in resolutions:
        s_hat = stft_magnitude(y_hat, n_fft, hop, win)
        s_ref = stft_magnitude(y, n_fft, hop, win)
        num = torch.sqrt(((s_ref - s_hat) ** 2).sum((1, 2)))
        den = torch.sqrt((s_ref ** 2).sum((1, 2)))
        sc_sum = sc_sum + torch.mean(num / torch.clamp(den, min=1e-8))
        lm_sum = lm_sum + torch.mean(torch.abs(
            torch.log(torch.clamp(s_hat, min=1e-5))
            - torch.log(torch.clamp(s_ref, min=1e-5))))
    n = len(resolutions)
    loss = (sc_sum + lm_sum) / n
    return loss, {"mr_sc": sc_sum / n, "mr_logmag": lm_sum / n}


def make_mel_fn(audio: AudioConfig, device=None
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """wav (B, T) → the training-scale log-mel (B, frames, n_mels), with
    the filterbank on ``device`` (the card unless ``"cpu"``), in the
    wav's dtype."""
    basis = torch.from_numpy(mel_filterbank(
        audio.sampling_rate, audio.filter_length, audio.n_mel_channels,
        audio.mel_fmin, audio.mel_fmax)).to(resolve_device(device))

    def mel_of(wav: torch.Tensor) -> torch.Tensor:
        mag = stft_magnitude(wav, audio.filter_length, audio.hop_length,
                             audio.win_length)
        m = torch.einsum("mf,btf->btm", basis.to(mag.dtype), mag)
        return torch.log(torch.clamp(m, min=1e-5))

    return mel_of


@dataclasses.dataclass
class VocoderTrainState:
    step: int
    gen: HifiGanGenerator
    gen_opt: torch.optim.Optimizer
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    disc_opt: torch.optim.Optimizer


def _disc_params(mpd: nn.Module, msd: nn.Module):
    return list(mpd.parameters()) + list(msd.parameters())


def _set_grads(params, grads):
    for p, g in zip(params, grads):
        if g is None:
            p.grad.zero_()
        else:
            p.grad.copy_(g)


def create_vocoder_trainer(cfg: HifiGanConfig, audio: AudioConfig,
                           lr: float = 2e-4, b1: float = 0.8,
                           b2: float = 0.99, mel_weight: float = 45.0,
                           fm_weight: float = 2.0,
                           mr_stft_weight: float = 0.0,
                           weight_decay: float = 0.01, device=None,
                           mesh: Optional[Mesh] = None):
    """Returns ``(gen, init, train_step)``.

    ``gen`` is the generator on ``device`` (the card unless ``"cpu"``;
    without a card that raises).  ``init(seed=0, gen_params=None,
    disc_params=None)`` gives a ``VocoderTrainState`` around ``gen`` and
    fresh discriminators: JAX-layout trees (``gen_params``, and
    ``disc_params`` as ``{"mpd": ..., "msd": ...}``) are loaded where
    given, the rest is the native init from ``seed``.  weight_decay 0.01
    is torch.optim.AdamW's default, which the upstream HiFi-GAN recipe
    uses.

    ``train_step(state, mel, wav)`` → (state, metrics): the discriminator
    step on a detached generator output, then the generator step against
    the updated discriminators.  On a ``mesh`` mel and wav are this
    rank's rows of the global batch, and the gradients and metrics are
    those of the global batch."""
    device = resolve_device(device)
    group = None if mesh is None else mesh.group("data")
    scale = 1.0 / group_size(group)
    gen = HifiGanGenerator(cfg).to(device)
    mel_of = make_mel_fn(audio, device)

    def adamw(params):
        return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=1e-8,
                                 weight_decay=weight_decay)

    def init(seed: int = 0, gen_params: Optional[Mapping] = None,
             disc_params: Optional[Mapping] = None) -> VocoderTrainState:
        mpd, msd = MultiPeriodDiscriminator(), MultiScaleDiscriminator()
        gen.cpu()
        for i, (module, tree) in enumerate((
                (gen, gen_params),
                (mpd, (disc_params or {}).get("mpd")),
                (msd, (disc_params or {}).get("msd")))):
            if tree is None:
                init_params(module, seed + i)
            else:
                load_jax_params(module, tree)
        # every parameter gets a gradient buffer, so AdamW decays every
        # parameter each step, as optax's adamw does
        for module in (gen, mpd, msd):
            module.to(device)
            for p in module.parameters():
                p.grad = torch.zeros_like(p)
        return VocoderTrainState(
            step=0, gen=gen, gen_opt=adamw(gen.parameters()), mpd=mpd,
            msd=msd, disc_opt=adamw(_disc_params(mpd, msd)))

    def train_step(state: VocoderTrainState, mel: torch.Tensor,
                   wav: torch.Tensor
                   ) -> Tuple[VocoderTrainState, Dict[str, torch.Tensor]]:
        y_hat = state.gen(mel)

        # the discriminators' step, on the generator's output held fixed
        disc_params = _disc_params(state.mpd, state.msd)
        y_fixed = y_hat.detach()
        p_r, p_g, _, _ = state.mpd(wav, y_fixed)
        s_r, s_g, _, _ = state.msd(wav, y_fixed)
        d_loss = discriminator_loss(p_r, p_g)[0] + \
            discriminator_loss(s_r, s_g)[0]
        _set_grads(disc_params, torch.autograd.grad(
            d_loss, disc_params, allow_unused=True))
        sum_gradients(disc_params, group, scale)
        state.disc_opt.step()

        # the generator's step, against the updated discriminators; the
        # gradients are taken for the generator's parameters alone, so no
        # discriminator .grad is touched
        with torch.no_grad():
            mel_ref = mel_of(wav)
        mel_l1 = torch.mean(torch.abs(mel_of(y_hat) - mel_ref))
        p_r, p_g, p_fr, p_fg = state.mpd(wav, y_hat, real_grad=False)
        s_r, s_g, s_fr, s_fg = state.msd(wav, y_hat, real_grad=False)
        adv = generator_loss(p_g)[0] + generator_loss(s_g)[0]
        fm = feature_loss(p_fr, p_fg) + feature_loss(s_fr, s_fg)
        total = adv + fm_weight * fm + mel_weight * mel_l1
        metrics = {"mel_l1": mel_l1, "adv": adv, "fm": fm}
        if mr_stft_weight > 0.0:
            mr, _ = multi_resolution_stft_loss(y_hat, wav)
            total = total + mr_stft_weight * mr
            metrics["mr_stft"] = mr
        gen_params = list(state.gen.parameters())
        _set_grads(gen_params, torch.autograd.grad(
            total, gen_params, allow_unused=True))
        sum_gradients(gen_params, group, scale)
        state.gen_opt.step()

        state.step += 1
        metrics = {"disc_loss": d_loss, "gen_loss": total, **metrics}
        return state, reduce_metrics(metrics, group, scale)

    return gen, init, train_step


# --- checkpoints: <dir>/step_<8 digits>.pt -----------------------------------

def save_vocoder_checkpoint(ckpt_dir: str, state: VocoderTrainState) -> str:
    """The generator, both discriminators, both optimizers' states and the
    step, written with ``torch.save``."""
    ckpt_dir = os.path.abspath(os.path.expanduser(ckpt_dir))
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}.pt")
    tmp = path + ".tmp"
    torch.save({"step": state.step, "gen": state.gen.state_dict(),
                "mpd": state.mpd.state_dict(),
                "msd": state.msd.state_dict(),
                "gen_opt": state.gen_opt.state_dict(),
                "disc_opt": state.disc_opt.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def restore_vocoder_checkpoint(path: str, state: VocoderTrainState
                               ) -> VocoderTrainState:
    """Load a vocoder checkpoint into ``state``, on its device."""
    dev = next(state.gen.parameters()).device
    payload = torch.load(path, map_location=dev, weights_only=True)
    for name in ("gen", "mpd", "msd"):
        getattr(state, name).load_state_dict(payload[name], strict=True)
    state.gen_opt.load_state_dict(payload["gen_opt"])
    state.disc_opt.load_state_dict(payload["disc_opt"])
    state.step = int(payload["step"])
    return state
