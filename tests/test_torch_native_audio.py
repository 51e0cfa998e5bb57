"""The port's native audio loader (runtime/audio_native.py over
csrc/audio_native.cpp, built by core/cuda_build.py with the host compiler)
and its `utils/audio.load_audio` against the JAX package's, bit for bit:
the same C++ code compiled with the same flags on the same machine gives the
same samples. Numpy-seeded signals written as PCM8/16/24/32 and float32
WAVs, mono and stereo, at 16, 22.05 and 44.1 kHz, read at their own rate and
resampled to 16 kHz; a batch with a missing file; the corrupt headers of
tests/test_native_audio.py; mp3 through pygame where it is installed, and
JAX's error without it; a failed build raises with the compiler's log."""
import os
import struct
import sys
from math import gcd

import numpy as np
import pytest
from scipy.io import wavfile
from scipy.signal import upfirdn

from multimodaltopicsegmentation_tpu.runtime import audio_native as J
from multimodaltopicsegmentation_tpu.utils import audio as JA
from multimodaltopicsegmentation_torch.core import cuda_build
from multimodaltopicsegmentation_torch.runtime import audio_native as P
from multimodaltopicsegmentation_torch.utils import audio as PA

def _pygame_sample():
    """pygame's own example mp3 (about 7.26 s), or None without pygame."""
    import importlib.util

    spec = importlib.util.find_spec("pygame")
    if spec is None:
        return None
    path = os.path.join(os.path.dirname(spec.origin), "examples", "data", "house_lo.mp3")
    return path if os.path.exists(path) else None


MP3_SAMPLE = _pygame_sample()


def _has_mp3_decoder():
    return MP3_SAMPLE is not None


@pytest.fixture(scope="module", autouse=True)
def both_built():
    """The JAX package builds its library with make; the port's with its own
    g++ call. Both must be there for a bit-for-bit comparison."""
    assert J.available(), "the JAX package's native audio library did not build"
    assert P.available()


def _signal(sr, seconds, channels, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t)[:, None] + 0.2 * rng.standard_normal((len(t), channels))
    return np.clip(x, -0.999, 0.999).squeeze()


def _write_pcm(path, sr, x, bits):
    """A canonical PCM WAV of `bits` per sample (scipy writes no 24-bit)."""
    x = x.reshape(len(x), -1)
    channels = x.shape[1]
    if bits == 8:
        data = np.round(x * 127 + 128).astype(np.uint8).tobytes()
    else:
        ints = np.round(x * (2 ** (bits - 1) - 1)).astype(np.int64)
        data = b"".join(int(v).to_bytes(bits // 8, "little", signed=True) for v in ints.reshape(-1))
    block = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sr, sr * block, block, bits))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def _write(path, sr, x, kind):
    if kind == "float32":
        wavfile.write(path, sr, x.astype(np.float32))
    else:
        _write_pcm(path, sr, x, int(kind[3:]))


KINDS = ["pcm8", "pcm16", "pcm24", "pcm32", "float32"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sr", [16000, 22050, 44100])
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_bit_equal(tmp_path, kind, sr, channels):
    path = str(tmp_path / "a.wav")
    _write(path, sr, _signal(sr, 0.35, channels, seed=sr + channels), kind)
    for target in (0, 16000):
        got, got_sr = P.read_wav(path, target)
        want, want_sr = J.read_wav(path, target)
        assert got_sr == want_sr == (target or sr)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("sr_in,sr_out", [(22050, 16000), (44100, 16000), (16000, 48000),
                                          (48000, 16000)])
def test_resample_bit_equal(sr_in, sr_out):
    x = _signal(sr_in, 0.5, 1, seed=3).astype(np.float32)
    got, want = P.resample(x, sr_in, sr_out), J.resample(x, sr_in, sr_out)
    assert len(got) == len(x) * sr_out // sr_in
    assert got.tobytes() == want.tobytes()


def test_batch_with_a_missing_file(tmp_path):
    paths = []
    for i, (sr, kind) in enumerate([(16000, "pcm16"), (22050, "float32"), (44100, "pcm24")]):
        p = str(tmp_path / f"d{i}.wav")
        _write(p, sr, _signal(sr, 0.3, 1 + i % 2, seed=i), kind)
        paths.append(p)
    paths.insert(1, str(tmp_path / "missing.wav"))
    got, want = P.read_wav_batch(paths, 16000), J.read_wav_batch(paths, 16000)
    assert got[1] == want[1] == (None, 0)
    for (a, ra), (b, rb), p in zip(got, want, paths):
        if a is None:
            continue
        assert ra == rb == 16000 and a.tobytes() == b.tobytes()
        assert a.tobytes() == P.read_wav(p, 16000)[0].tobytes()


def _corrupt(tmp_path):
    zero_bits = tmp_path / "zero_bits.wav"
    zero_bits.write_bytes(
        b"RIFF" + struct.pack("<I", 36) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 0)
        + b"data" + struct.pack("<I", 8) + b"\x00" * 8)
    short_fmt = tmp_path / "short_fmt.wav"
    short_fmt.write_bytes(b"RIFF" + struct.pack("<I", 20) + b"WAVE"
                          + b"fmt " + struct.pack("<I", 4) + b"\x01\x00\x01\x00")
    not_riff = tmp_path / "not_riff.wav"
    not_riff.write_bytes(b"RIFX" + b"\x00" * 40)
    return {"zero_bits": str(zero_bits), "short_fmt": str(short_fmt), "not_riff": str(not_riff)}


@pytest.mark.parametrize("name", ["zero_bits", "short_fmt", "not_riff"])
def test_corrupt_headers_raise_as_in_jax(tmp_path, name):
    path = _corrupt(tmp_path)[name]
    with pytest.raises(RuntimeError) as want:
        J.read_wav(path)
    with pytest.raises(RuntimeError) as got:
        P.read_wav(path)
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError):
        PA.load_audio(path)


def test_oversized_data_chunk_is_clamped(tmp_path):
    huge = tmp_path / "huge.wav"
    huge.write_bytes(
        b"RIFF" + struct.pack("<I", 36) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
        + b"data" + struct.pack("<I", 0xFFFFFFF0) + b"\x01\x02" * 4)
    got, sr = P.read_wav(str(huge))
    want, _ = J.read_wav(str(huge))
    assert len(got) == 4 and sr == 16000 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind,sr,channels", [("pcm16", 16000, 1), ("pcm16", 44100, 2),
                                              ("float32", 22050, 1), ("pcm24", 44100, 2)])
def test_load_audio_equal_to_jax(tmp_path, kind, sr, channels):
    path = str(tmp_path / "doc.wav")
    _write(path, sr, _signal(sr, 1.2, channels, seed=7), kind)
    got, got_sr = PA.load_audio(path, 16000)
    want, want_sr = JA.load_audio(path, 16000)
    assert got_sr == want_sr == 16000
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_unsupported_extension(tmp_path):
    with pytest.raises(ValueError, match="unsupported audio format"):
        PA.load_audio(str(tmp_path / "doc.flac"))


@pytest.mark.skipif(not _has_mp3_decoder(), reason="no pygame/sample mp3")
def test_load_audio_mp3_equal_to_jax():
    got, sr = PA.load_audio(MP3_SAMPLE, target_sr=16000)
    want, _ = JA.load_audio(MP3_SAMPLE, target_sr=16000)
    assert sr == 16000 and got.dtype == np.float32 and got.ndim == 1
    assert 7.0 < len(got) / sr < 7.5
    assert got.tobytes() == want.tobytes()


def test_mp3_without_pygame_raises_jax_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "pygame", None)  # import pygame -> ImportError
    monkeypatch.setitem(sys.modules, "pygame.sndarray", None)
    with pytest.raises(RuntimeError) as want:
        JA.load_audio("/nowhere/doc.mp3")
    with pytest.raises(RuntimeError) as got:
        PA.load_audio("/nowhere/doc.mp3")
    assert str(got.value) == str(want.value)
    assert "pygame" in str(got.value)


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    """No fallback: a source g++ refuses raises with its log, nothing loads."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "audio_native.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(P, "_lib", None)
    with pytest.raises(RuntimeError, match=r"failed for csrc/audio_native\.cpp") as err:
        P.read_wav(str(tmp_path / "x.wav"))
    assert "error" in str(err.value)
    assert not P.available()
    assert cuda_build._loaded == {} and not list((tmp_path / "build").glob("*.so"))


def test_library_name_carries_source_flags_and_target():
    path = cuda_build.library_path("audio_native")
    assert path.parent == cuda_build.BUILD_DIR and path.name.startswith("audio_native-")
    assert "-march=native" in cuda_build.HOST_FLAGS and "-fopenmp" in cuda_build.HOST_FLAGS
    assert cuda_build.host_flags() == cuda_build.HOST_FLAGS  # this g++ has libgomp
    assert "-march=" in cuda_build._march_native()


def test_first_loads_on_two_threads_build_once(tmp_path, monkeypatch):
    """`prefetch_audio` reads its first documents on two threads, so the first
    two calls for a library not built yet arrive together: both get the one
    library, built once."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    together = threading.Barrier(2)

    def first_load(_):
        together.wait()
        return cuda_build.load("audio_native")

    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(first_load, range(2)))
    assert libs[0] is libs[1]
    assert [p.name for p in (tmp_path / "build").iterdir()] == \
        [cuda_build.library_path("audio_native").name]


def test_build_without_openmp_gives_the_same_bits(tmp_path, monkeypatch):
    """A compiler without the OpenMP runtime builds the loader without
    -fopenmp: one thread, another library name, the same samples."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "_host", {"target": cuda_build._march_native()})
    monkeypatch.setattr(cuda_build, "_probe",
                        lambda *a: "libgomp.spec\n" if a == ("-print-file-name=libgomp.spec",)
                        else pytest.fail(f"unexpected probe {a}"))
    monkeypatch.setattr(P, "_lib", None)
    assert "-fopenmp" not in cuda_build.host_flags()
    paths = []
    for i, (sr, kind, channels) in enumerate([(44100, "pcm16", 2), (22050, "float32", 1)]):
        paths.append(str(tmp_path / f"d{i}.wav"))
        _write(paths[-1], sr, _signal(sr, 0.4, channels, seed=20 + i), kind)
    got = P.read_wav_batch(paths, 16000)
    assert [p.name for p in (tmp_path / "build").glob("audio_native-*.so")] == \
        [cuda_build.library_path("audio_native").name]
    for (a, _), (b, _) in zip(got, J.read_wav_batch(paths, 16000)):
        assert a.tobytes() == b.tobytes()
    x = _signal(44100, 0.3, 1, seed=22).astype(np.float32)
    assert P.resample(x, 44100, 16000).tobytes() == J.resample(x, 44100, 16000).tobytes()


def native_resample_plain(x, sr_in, sr_out):
    """The native loader's resampler in float64 numpy: its Kaiser-windowed
    sinc (beta 8, cutoff 0.95 of the lower Nyquist, 32 zero crossings a
    side, I0 by its 32-term series) through scipy's upfirdn. For a
    downsampling ratio the filter's half length is a multiple of `down`, so
    output m is upfirdn's m + half / down."""
    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    if down < up:
        raise ValueError("native_resample_plain covers downsampling only")
    half, cutoff = 32 * down, 0.95 * 0.5 / down
    k = 2.0 * np.arange(1, 32)

    def i0(v):
        return 1.0 + np.cumprod((v[:, None] / k) ** 2, axis=1).sum(axis=1)

    n = np.arange(-half, half + 1, dtype=np.float64)
    sinc = np.where(n == 0, 2 * cutoff, np.sin(2 * np.pi * cutoff * n) / (np.pi * np.where(n == 0, 1, n)))
    window = i0(8.0 * np.sqrt(np.maximum(0.0, 1.0 - (n / half) ** 2))) / i0(np.array([8.0]))
    n_out = len(x) * up // down
    y = upfirdn(sinc * window * up, np.asarray(x, np.float64), up, down)
    return y[half // down : half // down + n_out]


@pytest.mark.parametrize("sr_in", [44100, 22050, 48000])
def test_resample_equals_chip_smokes_plain_version(sr_in):
    """The loader's resampler against its float64 plain version
    (Kaiser-windowed sinc through scipy's upfirdn)."""
    x = _signal(sr_in, 0.6, 1, seed=9).astype(np.float32)
    got = P.resample(x, sr_in, 16000)
    plain = native_resample_plain(x, sr_in, 16000)
    assert len(got) == len(plain) and np.abs(got - plain).max() < 1e-6


@pytest.mark.skipif(not _has_mp3_decoder(), reason="no pygame/sample mp3")
def test_mp3_extract_and_predict_ext_mp3_equal_jax(tmp_path, monkeypatch):
    """An mp3 corpus end to end: the inference extractor (--mfcc) of both
    packages gives the same units, and predict -ext .mp3 with one JAX-written
    BiLSTM checkpoint cuts the mp3 into the same segment wavs."""
    import pickle
    import shutil
    from types import SimpleNamespace

    import jax

    from multimodaltopicsegmentation_tpu.cli import extract_embeddings_inference as JE
    from multimodaltopicsegmentation_tpu.cli import predict as JP
    from multimodaltopicsegmentation_tpu.models.base import TaggerConfig
    from multimodaltopicsegmentation_tpu.models.taggers import BiLSTMTagger
    from multimodaltopicsegmentation_tpu.train import checkpoints as jax_ckpt
    from multimodaltopicsegmentation_torch.cli import extract_embeddings_inference as PE
    from multimodaltopicsegmentation_torch.cli import predict as PP

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    audio = tmp_path / "audio"
    audio.mkdir()
    shutil.copy(MP3_SAMPLE, audio / "doc0.mp3")
    embs = {}
    for name, mod, extra in (("jax", JE, {}), ("port", PE, {"device": "cpu"})):
        out = str(tmp_path / f"emb_{name}")
        mod.main(SimpleNamespace(
            vad=False, speechbrain=True, ecapa=False, openl3=False, wav2vec=False, CREPE=False,
            prosodic_feats=False, mfcc=True, audio_directory=str(audio), out_directory=out,
            uniform_interval=1.0, adaptive_uniform_segmentation=False, verbose=False,
            continue_from_check=False, **extra))
        embs[name] = np.load(os.path.join(out, "doc0.npy"))
    assert embs["port"].shape == embs["jax"].shape == (7, 200)
    np.testing.assert_allclose(embs["port"], embs["jax"], atol=1e-4, rtol=1e-5)

    cfg = TaggerConfig(embedding_dim=200, hidden_dim=8, num_layers=1, loss_fn="FocalLoss")
    params = jax.tree.map(np.asarray, BiLSTMTagger(cfg).init(jax.random.PRNGKey(1)))
    ckpt = str(tmp_path / "best_model")
    jax_ckpt.save(ckpt, params, cfg, "BiLSTM")
    hyp = tmp_path / "results.txt"
    hyp.write_text("Sentence encoder: mfcc\nNeural architecture: BiLSTM\n")
    # both packages decode the same embeddings; the threshold lies halfway
    # between the 4th and 5th of the seven scores
    x = np.load(tmp_path / "emb_port" / "doc0.npy")[None].astype(np.float32)
    logits = np.asarray(BiLSTMTagger(cfg).scores(params, x, np.array([7])))[0, :, 0]
    probs = np.sort(1 / (1 + np.exp(-logits.astype(np.float64))))
    th = repr(float((probs[3] + probs[4]) / 2))
    common = ["-ef", str(tmp_path / "emb_port"), "-hyp", str(hyp), "-model", ckpt,
              "-af", str(audio), "-ext", ".mp3", "-th", th]
    for name, mod, extra in (("jax", JP, []), ("port", PP, ["--device", "cpu"])):
        mod.cli_main(common + ["-exp", str(tmp_path / f"exp_{name}")] + extra)
    outs = []
    for name in ("jax", "port"):
        exp = tmp_path / f"exp_{name}"
        with open(exp / "results.pkl", "rb") as f:
            results = pickle.load(f)
        seg = exp / "audio_segments"
        wavs = {n: (seg / n).read_bytes() for n in sorted(os.listdir(seg))} \
            if seg.exists() else {}
        outs.append((results, wavs))
    assert outs[1] == outs[0]
    assert 0 < sum(outs[0][0]["doc0.npy"]) < 7 and len(outs[0][1]) >= 2
