"""The port stands alone: it imports neither JAX nor the JAX package, its
kernel modules import without a CUDA toolkit, and its entry points refuse
to fall back to the CPU silently."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parents[1] / "efficientspeech_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
    for p in PKG.rglob("*.py"))


def test_every_module_imports_with_jax_blocked():
    code = "\n".join([
        "import importlib, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',",
        "             'efficientspeech_tpu'):",
        "    sys.modules[name] = None",
        f"for mod in {MODULES!r}:",
        "    importlib.import_module(mod.removesuffix('.__init__'))",
        "leaked = [m for m in sys.modules if m.startswith(('jax', 'flax'))",
        "          and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('ok', len(sys.modules))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_jax_import_in_source():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax"
        r"|efficientspeech_tpu)(\.|\s|$)", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders, offenders
    assert len(MODULES) > 25


def test_kernel_modules_need_no_nvcc():
    code = "\n".join([
        "from efficientspeech_tpu_torch.ops.kernels import (",
        "    build, decoder_block, folded_matmul, int8_window, layer_norm,",
        "    mrf_block)",
        "from efficientspeech_tpu_torch.probes import int8_window as probe",
        "from efficientspeech_tpu_torch.training import loop",
        "assert set(build.SOURCES) >= {'layer_norm', 'decoder_block',",
        "                              'int8_window'}",
        "from efficientspeech_tpu_torch.models import hifigan_folded",
        "assert all((build.CSRC / f'{n}.cu').is_file()",
        "           for n in build.SOURCES)",
        "try:",
        "    build._nvcc()",
        "except RuntimeError:",
        "    print('no nvcc')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(PKG.parent),
                         env={"PATH": "/nonexistent"})
    assert out.returncode == 0, out.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    from efficientspeech_tpu_torch.device import resolve_device
    from efficientspeech_tpu_torch.infer import build_synthesizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_synthesizer(preset="tiny")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_raises_without_cuda(monkeypatch):
    """``python -m efficientspeech_tpu_torch.serve`` serves from the card
    and refuses to start without one unless asked for the CPU."""
    from efficientspeech_tpu_torch import serve

    class Stop(Exception):
        pass

    def stop(host, port, handler):
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(serve, "make_server", stop)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--port", "0"])
    with pytest.raises(Stop):  # built on the CPU; stopped before serving
        serve.main(["--port", "0", "--device", "cpu"])


def test_int8_probe_raises_without_cuda(monkeypatch, capsys):
    """The int8 probe times the card, and without one refuses to start
    unless asked for the CPU, where it runs K5's plain version."""
    from efficientspeech_tpu_torch.probes import int8_window as probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.main([])
    out = probe.main(["--device", "cpu"])
    assert set(out) == {"k5_bf16", "k5_int8"} and min(out.values()) > 0
    assert "plain on the cpu" in capsys.readouterr().out


def test_training_raises_without_cuda(monkeypatch, tmp_path):
    """Trainer and the train CLI run on the card, and refuse to start
    without one unless asked for the CPU."""
    from efficientspeech_tpu_torch import train
    from efficientspeech_tpu_torch.config import (
        ModelConfig, PreprocessConfig, TrainConfig)
    from efficientspeech_tpu_torch.training.loop import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PreprocessConfig(preprocessed_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(ModelConfig.preset("tiny"), TrainConfig(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--preprocess-config", str(tmp_path / "none.yaml")])


@pytest.mark.parametrize("cli", ["train", "demo"])
def test_precision_f32_turns_tf32_off(monkeypatch, tmp_path, cli):
    """``--precision f32`` keeps cuDNN's convolutions and cuBLAS's products
    out of TF32 before any model is built, so the model's other ops agree
    with its float32 kernels."""
    from efficientspeech_tpu_torch import demo, infer, train

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        raise Stop

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(infer, "build_synthesizer", stop)
    monkeypatch.setattr(train.PreprocessConfig, "from_yaml", stop)
    args = ["--device", "cpu", "--precision", "bf16"]
    if cli == "demo":
        args += ["--text", "hello"]
    main = {"train": train.main, "demo": demo.main}[cli]
    with pytest.raises(Stop):
        main(args)
    assert torch.backends.cudnn.allow_tf32
    with pytest.raises(Stop):
        main(args[:-1] + ["f32"] if cli == "train"
             else args[:3] + ["f32"] + args[4:])
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("entry", ["demo", "preprocess", "Preprocessor",
                                   "MelSpectrogram", "train_vocoder",
                                   "create_vocoder_trainer", "train_g2p",
                                   "G2pTrainer", "convert"])
def test_new_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    """The demo, the preprocessing, the vocoder- and G2P-training and the
    convert entry points compute on the card and refuse to start without
    one unless asked for the CPU (the CLIs' runs with ``--device cpu`` are
    in their own test files); prepare_align does no device work
    (tests/test_torch_preprocess.py runs it)."""
    from efficientspeech_tpu_torch import (
        demo, preprocess, train_g2p, train_vocoder)
    from efficientspeech_tpu_torch.convert import __main__ as convert
    from efficientspeech_tpu_torch.audio.stft import MelSpectrogram
    from efficientspeech_tpu_torch.config import (
        AudioConfig, HifiGanConfig, PreprocessConfig)
    from efficientspeech_tpu_torch.data.preprocessor import Preprocessor
    from efficientspeech_tpu_torch.training.vocoder import (
        create_vocoder_trainer)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    yaml = tmp_path / "p.yaml"
    yaml.write_text(f"path:\n  preprocessed_path: {tmp_path}\n")
    call = {
        "demo": lambda **kw: demo.main(
            ["--text", "hi", "--wav-path", str(tmp_path), "--warmup", "0",
             "--precision", "f32"] + (["--device", kw["device"]]
                                      if kw else [])),
        "preprocess": lambda **kw: preprocess.main(
            [str(yaml)] + (["--device", kw["device"]] if kw else [])),
        "Preprocessor": lambda **kw: Preprocessor(
            PreprocessConfig(preprocessed_path=str(tmp_path)), **kw),
        "MelSpectrogram": lambda **kw: MelSpectrogram(**kw),
        "train_vocoder": lambda **kw: train_vocoder.main(
            ["--preprocess-config", str(yaml)]
            + (["--device", kw["device"]] if kw else [])),
        "create_vocoder_trainer": lambda **kw: create_vocoder_trainer(
            HifiGanConfig(upsample_initial_channel=16), AudioConfig(), **kw),
        "train_g2p": lambda **kw: train_g2p.main(["--steps", "1"]),
        "G2pTrainer": lambda **kw: train_g2p.G2pTrainer(
            {"w": np.zeros((2, 2), np.float32)}, 4, **kw),
        "convert": lambda **kw: convert.main(
            ["--checkpoint", str(tmp_path / "absent.ckpt")]),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    if entry in ("Preprocessor", "MelSpectrogram", "create_vocoder_trainer",
                 "G2pTrainer"):
        call(device="cpu")


def test_parallel_modules_import_without_jax_or_a_process_group():
    """``parallel/`` stands alone like the rest of the port: its modules
    import with JAX blocked, and importing them starts no process group
    and spawns no rank."""
    parallel = [m for m in MODULES if ".parallel." in m]
    assert {m.rsplit(".", 1)[1] for m in parallel} >= {
        "__init__", "comm", "mesh", "seq_vocoder", "sharding"}
    code = "\n".join([
        "import importlib, multiprocessing, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',",
        "             'efficientspeech_tpu'):",
        "    sys.modules[name] = None",
        f"for mod in {parallel!r}:",
        "    importlib.import_module(mod.removesuffix('.__init__'))",
        "import torch.distributed as dist",
        "assert not dist.is_initialized()",
        "assert not multiprocessing.active_children()",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
