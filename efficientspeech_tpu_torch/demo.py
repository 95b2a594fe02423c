"""Text → speech demo on the port.

    python -m efficientspeech_tpu_torch.demo --text "the quick brown fox" \
        --wav-filename fox.wav

Weights are a native random init from ``--seed`` (loading the reference
checkpoints is not ported yet), so the voice is noise-like; the run shows
the path end to end and its timings.  It runs on the card unless
``--device cpu`` is given.  ``--precision f32`` serves in float32
throughout: the vocoder's kernels run their float32 variants, and cuDNN's
convolutions and cuBLAS's products are kept out of TF32.
"""

import argparse
import os

import numpy as np

from efficientspeech_tpu_torch.audio.transfer import FORMATS
from efficientspeech_tpu_torch.infer import VOCODER_MODES


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="tiny",
                        choices=["tiny", "small", "base"])
    parser.add_argument("--text", required=True)
    parser.add_argument("--wav-path", default="outputs")
    parser.add_argument("--wav-filename", default="efficient_speech.wav")
    parser.add_argument("--iter", type=int, default=1,
                        help="timed synthesis iterations")
    parser.add_argument("--warmup", type=int, default=1)
    parser.add_argument("--precision", default="bf16", choices=["bf16", "f32"],
                        help="serving dtype: bf16, or float32 throughout "
                             "(TF32 off)")
    parser.add_argument("--transfer", default="int16",
                        choices=list(FORMATS),
                        help="card → host PCM wire format (adpcm4/3/2: "
                             "block-ADPCM encoded by a CUDA kernel)")
    parser.add_argument("--vocoder", default="folded_kernel",
                        choices=list(VOCODER_MODES),
                        help="folded_kernel: the CUDA kernels from 2,048 "
                             "speculative frames on; folded: plain "
                             "matmuls; chunked: the conv generator over "
                             "128-frame chunks (split pipeline)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bench-duration-bias", type=float, default=4.0,
                        help="duration head bias for random weights")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    import torch
    from scipy.io import wavfile

    from efficientspeech_tpu_torch.device import set_full_f32
    from efficientspeech_tpu_torch.infer import build_synthesizer

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if dtype == torch.float32:
        set_full_f32()
    synth = build_synthesizer(preset=args.preset, dtype=dtype, seed=args.seed,
                              bench_duration_bias=args.bench_duration_bias,
                              transfer=args.transfer,
                              vocoder_mode=args.vocoder, device=args.device)
    for _ in range(args.warmup):
        synth.tts(args.text)
    wav, info = None, None
    for _ in range(max(1, args.iter)):
        wav, info = synth.tts(args.text)
    print(f"device={synth.device} phonemes={info['phoneme_len']} "
          f"mel_len={info['mel_len']} voice={info['voice_secs']:.2f}s "
          f"synth={info['total_secs'] * 1e3:.1f}ms RTF={info['rtf']:.1f}")
    os.makedirs(args.wav_path, exist_ok=True)
    path = os.path.join(args.wav_path, args.wav_filename)
    pcm = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
    wavfile.write(path, synth.sampling_rate, pcm)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
