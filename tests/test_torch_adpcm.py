"""The port's block-ADPCM wire codecs against the JAX package's: the plain
encoders bit for bit against the JAX encoders under jax.jit, the numpy
decoders against JAX's, the wire sizes, and the round trip through the
port's transfer layer."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientspeech_tpu.audio import adpcm as jax_adpcm
from efficientspeech_tpu.audio import transfer as jax_transfer
from efficientspeech_tpu_torch.audio import adpcm, transfer
from efficientspeech_tpu_torch.ops.kernels import adpcm as adpcm_kernel

BITS = {"adpcm4": 4, "adpcm3": 3, "adpcm2": 2}
JAX_ENCODERS = {4: jax_adpcm.encode_blocks_device,
                3: jax_adpcm.encode3_blocks_device,
                2: jax_adpcm.encode2_blocks_device}
PLAIN = {4: adpcm.encode_blocks_plain, 3: adpcm.encode3_blocks_plain,
         2: adpcm.encode2_blocks_plain}
DECODERS = {4: ("_decode_numpy", adpcm.BLOCK_BYTES),
            3: ("_decode3_numpy", adpcm.BLOCK3_BYTES),
            2: ("_decode2_numpy", adpcm.BLOCK2_BYTES)}
# the JAX tests' SNR bars on a speech-like signal (tests/test_transfer.py)
SNR_BAR = {"adpcm4": 32.0, "adpcm3": 32.0, "adpcm2": 22.0}
# every case has this shape, so each width's jit compiles once
SHAPE = (3, 6 * adpcm.BLOCK)


def _case(name: str) -> np.ndarray:
    """Three rows of six 256-sample blocks; ``mixed`` puts a constant, a
    full-scale, a clipped, an alternating full-swing and a silent block
    beside random ones."""
    rng = np.random.default_rng(len(name))
    if name == "random":
        return rng.uniform(-0.9, 0.9, SHAPE).astype(np.float32)
    if name == "constant":
        return np.full(SHAPE, -0.3125, np.float32)
    if name == "full_scale":
        return np.where(rng.random(SHAPE) < 0.5, -1.0, 1.0).astype(
            np.float32)
    if name == "clipped":
        return rng.uniform(-3.0, 3.0, SHAPE).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, SHAPE).astype(np.float32)
    blk = adpcm.BLOCK
    x[0, :blk] = 0.25
    x[1, blk:2 * blk] = 1.0
    x[2, 2 * blk:3 * blk] = rng.uniform(-4.0, 4.0, blk)
    x[0, 3 * blk:4 * blk] = np.where(np.arange(blk) % 2, 1.0, -1.0)
    x[1, 4 * blk:5 * blk] = 0.0
    # values on the int16 grid's half-way points round half to even
    x[2, 5 * blk:] = (np.arange(blk) + 0.5) / 32767.0
    return x


def _speechlike(n: int, seed: int = 0) -> np.ndarray:
    """The JAX tests' speech-like signal: a harmonic stack under an
    amplitude envelope, and breath noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    f0 = 140 + 40 * np.sin(2 * np.pi * 2.1 * t)
    phase = np.cumsum(2 * np.pi * f0 / 22050.0)
    x = (0.5 * np.sin(phase) + 0.25 * np.sin(2 * phase)
         + 0.12 * np.sin(3 * phase))
    env = 0.3 + 0.7 * (0.5 + 0.5 * np.sin(2 * np.pi * 3.7 * t)) ** 2
    x = x * env + 0.01 * rng.normal(size=n)
    return (0.8 * x / np.abs(x).max()).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "constant", "full_scale",
                                  "clipped", "mixed"])
@pytest.mark.parametrize("bits", [4, 3, 2])
def test_plain_encoder_bit_equal_to_jax(bits, case):
    x = _case(case)
    want = np.asarray(jax.jit(JAX_ENCODERS[bits])(jnp.asarray(x)))
    got = PLAIN[bits](torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (
        SHAPE[0], SHAPE[1] // adpcm.BLOCK * DECODERS[bits][1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [4, 3, 2])
def test_decoder_bit_equal_to_jax(bits):
    """On an encoded signal and on random bytes (any bytes decode)."""
    name, block_bytes = DECODERS[bits]
    wire = PLAIN[bits](torch.from_numpy(_case("mixed"))).numpy().ravel()
    noise = np.random.default_rng(bits).integers(
        0, 256, 5 * block_bytes).astype(np.uint8)
    for data in (wire, noise):
        n_blocks = len(data) // block_bytes
        want = getattr(jax_adpcm, name)(data, n_blocks)
        got = getattr(adpcm, name)(data, n_blocks)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", transfer.FORMATS)
def test_wire_sizes_agree_with_jax(fmt):
    for n in (0, 1, 255, 256, 257, 4096, 100_000):
        assert (transfer.elements_for_samples(fmt, n)
                == jax_transfer.elements_for_samples(fmt, n))
        assert (transfer.samples_for_elements(fmt, n)
                == jax_transfer.samples_for_elements(fmt, n))
    assert transfer.bytes_per_sample(fmt) == jax_transfer.bytes_per_sample(
        fmt)


@pytest.mark.parametrize("fmt", ["adpcm4", "adpcm3", "adpcm2"])
def test_transfer_roundtrip_snr(fmt):
    """encode_device → decode_host through the port's transfer layer, on
    the CPU (the plain encoder), at the JAX tests' SNR bars; a prefix of
    the wire decodes to the prefix of the whole, and the host decoder
    drops a partial block at the end."""
    n = 64 * adpcm.BLOCK
    x = _speechlike(n)
    wire = transfer.encode_device(torch.from_numpy(x[None]), fmt).numpy()
    assert wire.shape == (1, transfer.elements_for_samples(fmt, n))
    assert transfer.samples_for_elements(fmt, wire.shape[1]) == n
    y = transfer.decode_host(wire[0], fmt)
    assert y.shape == (n,) and y.dtype == np.float32
    snr = 10 * np.log10((x ** 2).sum() / ((x - y) ** 2).sum())
    assert snr > SNR_BAR[fmt], snr
    k = transfer.elements_for_samples(fmt, 3 * adpcm.BLOCK)
    np.testing.assert_array_equal(transfer.decode_host(wire[0, :k + 7], fmt),
                                  y[: 3 * adpcm.BLOCK])


@pytest.mark.parametrize("fmt", ["adpcm4", "adpcm3", "adpcm2"])
def test_device_encoder_takes_the_plain_version_on_cpu(fmt):
    """On a CPU tensor the device encoders are the plain versions and
    launch nothing."""
    x = torch.from_numpy(_case("random"))
    before = dict(adpcm_kernel.launches)
    got = transfer.encode_device(x, fmt)
    assert adpcm_kernel.launches == before
    assert torch.equal(got, PLAIN[BITS[fmt]](x))


def test_adpcm_encode_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, adpcm.BLOCK)
    with pytest.raises(ValueError, match="bits"):
        adpcm_kernel.adpcm_encode(x, 5)
    with pytest.raises(ValueError, match="multiple of 256"):
        adpcm_kernel.adpcm_encode(torch.zeros(2, 300), 4)


# --- the C++ host decoder ---

HOST = {4: (adpcm.decode_blocks_host, jax_adpcm.decode_blocks_host),
        3: (adpcm.decode3_blocks_host, jax_adpcm.decode3_blocks_host),
        2: (adpcm.decode2_blocks_host, jax_adpcm.decode2_blocks_host)}


@pytest.mark.parametrize("bits", [4, 3, 2])
def test_c_decoder_bit_equal_to_numpy_and_jax(bits):
    """Seeded random wire bytes with a partial block at the end: the C++
    decoder gives the numpy decoder's samples bit for bit, and the JAX
    package's host decoder's (its C library, or its numpy fallback)."""
    name, block_bytes = DECODERS[bits]
    rng = np.random.default_rng(40 + bits)
    n_blocks = 37
    data = rng.integers(0, 256, n_blocks * block_bytes + block_bytes // 3
                        ).astype(np.uint8)
    decode, jax_decode = HOST[bits]
    got = decode(data)
    want = getattr(adpcm, name)(data[: n_blocks * block_bytes], n_blocks)
    assert got.dtype == np.float32 and got.shape == (n_blocks * adpcm.BLOCK,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_decode(data))


def _isolated_build(monkeypatch, tmp_path):
    """Point the host build at a copy of csrc/adpcm_decode.cpp and an
    empty build directory."""
    from efficientspeech_tpu_torch.ops.kernels import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "adpcm_decode.cpp").write_bytes(
        (build.CSRC / "adpcm_decode.cpp").read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "HOST_BUILD_DIR", tmp_path / "build" / "host")
    monkeypatch.setattr(build, "_loaded", {})
    return build, csrc


def test_c_decoder_builds_at_first_use_and_on_source_change(
        monkeypatch, tmp_path):
    build, csrc = _isolated_build(monkeypatch, tmp_path)
    wire = PLAIN[4](torch.from_numpy(_case("random"))).numpy()
    assert not build.HOST_BUILD_DIR.exists()
    first = adpcm.decode_blocks_host(wire[0])
    libs = sorted(p.name for p in build.HOST_BUILD_DIR.iterdir())
    assert len(libs) == 1 and libs[0].startswith("libadpcm_decode_")
    assert adpcm.decode_lib() is adpcm.decode_lib()  # loaded once
    # an edited source gets a library of its own name, built at the next
    # process's first use (here: the loaded libraries forgotten)
    src = csrc / "adpcm_decode.cpp"
    src.write_text(src.read_text() + "\n// edited\n")
    monkeypatch.setattr(build, "_loaded", {})
    np.testing.assert_array_equal(adpcm.decode_blocks_host(wire[0]), first)
    libs2 = sorted(p.name for p in build.HOST_BUILD_DIR.iterdir())
    assert len(libs2) == 2 and libs[0] in libs2


def test_c_decoder_rebuilt_for_another_cpu(monkeypatch, tmp_path):
    """``-march=native`` code is for the CPU that built it: a library
    built where g++ saw another target keeps its name and is not loaded
    here; this CPU's own is built beside it."""
    build, _ = _isolated_build(monkeypatch, tmp_path)
    wire = PLAIN[2](torch.from_numpy(_case("random"))).numpy()
    here = build._host_target
    monkeypatch.setattr(build, "_host_target", lambda gxx: b"another cpu")
    first = adpcm.decode2_blocks_host(wire[0])
    other = sorted(p.name for p in build.HOST_BUILD_DIR.iterdir())
    monkeypatch.setattr(build, "_host_target", here)
    monkeypatch.setattr(build, "_loaded", {})
    np.testing.assert_array_equal(adpcm.decode2_blocks_host(wire[0]), first)
    libs = sorted(p.name for p in build.HOST_BUILD_DIR.iterdir())
    assert len(other) == 1 and len(libs) == 2 and other[0] in libs


def test_c_decoder_raises_without_a_compiler(monkeypatch, tmp_path):
    """No g++ and no library built: the decoder raises instead of quietly
    decoding in numpy."""
    import shutil

    _isolated_build(monkeypatch, tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    wire = PLAIN[3](torch.from_numpy(_case("random"))).numpy()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        adpcm.decode3_blocks_host(wire[0])
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        transfer.decode_host(wire[0], "adpcm3")


def test_c_decoder_raises_with_the_compiler_output(monkeypatch, tmp_path):
    build, csrc = _isolated_build(monkeypatch, tmp_path)
    (csrc / "adpcm_decode.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        adpcm.decode_lib()
    assert not any(build.HOST_BUILD_DIR.glob("*.so"))
