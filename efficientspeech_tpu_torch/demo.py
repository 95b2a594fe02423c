"""Text → speech demo on the port (counterpart of the root ``demo.py``).

    python -m efficientspeech_tpu_torch.demo --text "the quick brown fox" \
        --wav-filename fox.wav
    python -m efficientspeech_tpu_torch.demo --checkpoint tiny_eng_266k.ckpt \
        --hifigan-checkpoint LJ_V2/generator_v2 --text "hello world"

``--checkpoint`` is a reference EfficientSpeech checkpoint (a Lightning
``.ckpt``, converted on load), a ``step_*.pt`` of the port's trainer or
its directory, or an http(s) URL fetched to the working directory first.
Without one the weights are a native random init from ``--seed`` with a
duration bias of 6.0, so the voice is noise-like.  The vocoder comes from
``--hifigan-checkpoint`` (its ``config.json`` beside it chooses the
shape), else it is a random init.  It runs on the card unless
``--device cpu`` is given.  ``--precision f32`` serves in float32
throughout: the vocoder's kernels run their float32 variants, and cuDNN's
convolutions and cuBLAS's products are kept out of TF32.  A ``.onnx``
checkpoint (``python -m efficientspeech_tpu_torch.convert --onnx``) runs
under onnxruntime, which must be installed, at its fixed
``--onnx-insize``.  ``--play`` plays the audio through sounddevice, or
saves it when that is not installed.
"""

import argparse
import os

from efficientspeech_tpu_torch.audio.transfer import FORMATS
from efficientspeech_tpu_torch.config import add_arch_args, arch_overrides
from efficientspeech_tpu_torch.infer import VOCODER_MODES

# the duration head's bias for random weights, as the JAX demo sets it
RANDOM_INIT_DURATION_BIAS = 6.0


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="tiny",
                        choices=["tiny", "small", "base"])
    parser.add_argument("--checkpoint", default=None,
                        help="reference .ckpt (converted), a step_*.pt of "
                             "the port's trainer or its directory, a native "
                             "parameter file, a .onnx (run under "
                             "onnxruntime), or a URL of one")
    parser.add_argument("--onnx-insize", type=int, default=128,
                        help="fixed phoneme input length baked into the "
                             ".onnx graph (convert --insize)")
    parser.add_argument("--hifigan-checkpoint", default=None,
                        help="reference HiFi-GAN generator file; random "
                             "vocoder weights without one")
    parser.add_argument("--preprocess-config", default=None,
                        help="preprocess yaml (for lexicon / audio params)")
    parser.add_argument("--text", required=True)
    parser.add_argument("--wav-path", default="outputs")
    parser.add_argument("--wav-filename", default="efficient_speech.wav")
    parser.add_argument("--iter", type=int, default=1,
                        help="timed synthesis iterations")
    parser.add_argument("--warmup", type=int, default=1)
    parser.add_argument("--precision", default="bf16", choices=["bf16", "f32"],
                        help="serving dtype: bf16, or float32 throughout "
                             "(TF32 off)")
    parser.add_argument("--speaker", type=int, default=None,
                        help="speaker id for multi-speaker checkpoints")
    parser.add_argument("--transfer", default="int16",
                        choices=list(FORMATS),
                        help="card → host PCM wire format (adpcm4/3/2: "
                             "block-ADPCM encoded by a CUDA kernel)")
    parser.add_argument("--vocoder", default="folded_kernel",
                        choices=list(VOCODER_MODES),
                        help="folded_kernel: the CUDA kernels on the "
                             "card (on the CPU from 2,048 speculative "
                             "frames on); folded: plain matmuls; chunked: the conv generator over "
                             "128-frame chunks (split pipeline)")
    parser.add_argument("--play", action="store_true",
                        help="play audio instead of saving (needs "
                             "sounddevice)")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random init")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    add_arch_args(parser)
    return parser.parse_args(argv)


def _maybe_download(checkpoint):
    """URL checkpoints are fetched to the working directory first
    (reference: demo.py:100-102).  Zero-egress environments get a clear
    error instead of a hang."""
    if not (checkpoint and checkpoint.startswith(("http://", "https://"))):
        return checkpoint
    import urllib.request

    local = checkpoint.rsplit("/", 1)[-1]
    if not os.path.isfile(local):
        print(f"downloading {checkpoint} -> {local}")
        try:
            urllib.request.urlretrieve(checkpoint, local)
        except OSError as e:
            raise SystemExit(
                f"could not download {checkpoint}: {e} "
                "(no network egress? pass a local path instead)") from e
    return local


def run_onnx(args):
    """Run an exported ``.onnx`` under onnxruntime, an optional
    dependency: without it, a clear SystemExit.  The graph's contract is
    the exporter's (``convert/onnx_export.py``): inputs (1, insize) int →
    (wav, lengths, duration), duration in mel frames; the text is padded
    with silence words to ``--onnx-insize`` phonemes, and the wav is
    trimmed to the rounded durations of its real phonemes × hop."""
    try:
        import onnxruntime
    except ImportError:
        raise SystemExit(
            "onnxruntime is not installed; .onnx checkpoints need it "
            "(pip install onnxruntime).  Reference .ckpt and the port's "
            "checkpoints run without it.")
    import time

    import numpy as np

    from efficientspeech_tpu_torch.config import PreprocessConfig
    from efficientspeech_tpu_torch.text.g2p import (
        get_lexicon_and_g2p, text2phoneme)
    from efficientspeech_tpu_torch.utils.tools import write_wav

    cfg = (PreprocessConfig.from_yaml(args.preprocess_config)
           if args.preprocess_config else PreprocessConfig())
    lexicon, g2p = get_lexicon_and_g2p(cfg)
    session = onnxruntime.InferenceSession(args.checkpoint)
    in_name = session.get_inputs()[0].name

    text = args.text.strip().replace("-", " ")
    n_real = min(len(text2phoneme(lexicon, g2p, text, cfg)),
                 args.onnx_insize)
    # the fixed-insize graph: pad the text with silence words, truncate
    padded = text + 2 * args.onnx_insize * "- "
    phoneme = text2phoneme(lexicon, g2p, padded, cfg)[None, :args.onnx_insize]
    ort_inputs = {in_name: phoneme.astype(np.int32)}

    wav = lengths = duration = None
    elapsed = []
    for _ in range(max(1, args.iter)):
        t0 = time.perf_counter()
        wav, lengths, duration = session.run(None, ort_inputs)
        elapsed.append(time.perf_counter() - t0)
    hop = cfg.audio.hop_length
    n_samples = int(np.sum(np.round(np.asarray(duration).squeeze())
                           [:n_real])) * hop
    wav = np.asarray(wav).squeeze()[:n_samples]
    voice_secs = len(wav) / cfg.audio.sampling_rate
    med = float(np.median(elapsed))
    print(f"voice length: {voice_secs:.2f}s  synthesis: {med * 1e3:.2f}ms  "
          f"median RTF over {len(elapsed)} iter(s): {voice_secs / med:.1f} "
          f"(onnxruntime, lengths={np.asarray(lengths).ravel()[:1]})")
    path = os.path.join(args.wav_path, args.wav_filename)
    write_wav(wav, path, cfg.audio.sampling_rate, cfg.audio.max_wav_value)
    print(f"wrote {path}")
    return wav


def main(argv=None):
    args = get_args(argv)
    args.checkpoint = _maybe_download(args.checkpoint)
    if args.checkpoint and args.checkpoint.endswith(".onnx"):
        return run_onnx(args)
    import torch

    from efficientspeech_tpu_torch.config import PreprocessConfig
    from efficientspeech_tpu_torch.device import set_full_f32
    from efficientspeech_tpu_torch.infer import build_synthesizer
    from efficientspeech_tpu_torch.utils.tools import write_wav

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if dtype == torch.float32:
        set_full_f32()
    preprocess_cfg = (PreprocessConfig.from_yaml(args.preprocess_config)
                      if args.preprocess_config else None)
    hifigan_ckpt = args.hifigan_checkpoint
    if not (hifigan_ckpt and os.path.isfile(hifigan_ckpt)):
        print(f"note: hifigan checkpoint {hifigan_ckpt} not found; "
              "using random vocoder weights")
        hifigan_ckpt = None
    synth = build_synthesizer(
        preset=args.preset, checkpoint=args.checkpoint,
        hifigan_checkpoint=hifigan_ckpt, preprocess_cfg=preprocess_cfg,
        dtype=dtype, seed=args.seed,
        bench_duration_bias=(None if args.checkpoint
                             else RANDOM_INIT_DURATION_BIAS),
        transfer=args.transfer, vocoder_mode=args.vocoder,
        model_overrides=arch_overrides(args), device=args.device)
    for _ in range(args.warmup):
        synth.tts(args.text, speaker=args.speaker)
    wav, info = None, None
    for _ in range(max(1, args.iter)):
        wav, info = synth.tts(args.text, verbose=args.verbose,
                              speaker=args.speaker)
    print(f"device={synth.device} phonemes={info['phoneme_len']} "
          f"mel_len={info['mel_len']} voice={info['voice_secs']:.2f}s "
          f"synth={info['total_secs'] * 1e3:.1f}ms RTF={info['rtf']:.1f}")
    if args.play:
        try:
            import sounddevice as sd

            sd.play(wav, synth.sampling_rate)
            sd.wait()
        except ImportError:
            print("sounddevice not installed; saving to file instead")
            args.play = False
    if not args.play:
        path = os.path.join(args.wav_path, args.wav_filename)
        write_wav(wav, path, synth.sampling_rate,
                  synth.preprocess_cfg.audio.max_wav_value)
        print(f"wrote {path}")
    return wav, info


if __name__ == "__main__":
    main()
