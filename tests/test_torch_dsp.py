"""The port's DSP front-end (dsp/spectral, yin, pyin, prosody, vad) against
the JAX package on the CPU.

Inputs are numpy-seeded: sines at 110/220/330 Hz, a one-octave glide, white
noise, silence, a 500-sample unit and a zero-length padded row, batched
ragged as the encoders batch them (rows padded, then framed whole).
Tolerances: mel and power spectra rtol 1e-4 of each row's maximum; dB and
MFCC atol 1e-4 of each row's largest magnitude (float32 holds about 7
digits of MFCC c0 near 10^3); CMNDF atol 1e-9 in float64 and 2e-4 in
float32 (the FFT identity d = e_head + e_tail - 2 acf cancels: each
package's float32 CMNDF lies about 1e-4 from its float64 one); voicing
probability atol 1e-5;
trough choices, Viterbi states, voiced flags, pause statistics and VAD spans
identical; unit feature vectors atol and rtol 1e-4, plus two float32 ulps
of the row's largest magnitude (a silent row's MFCCs all sit near -1131,
whose std each package rounds to 0 or to one ulp, 1.2e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.dsp import prosody as JP
from multimodaltopicsegmentation_tpu.dsp import pyin as JPY
from multimodaltopicsegmentation_tpu.dsp import spectral as JS
from multimodaltopicsegmentation_tpu.dsp import vad as JV
from multimodaltopicsegmentation_tpu.dsp import yin as JY
from multimodaltopicsegmentation_torch.dsp import prosody as TP
from multimodaltopicsegmentation_torch.dsp import pyin as TPY
from multimodaltopicsegmentation_torch.dsp import spectral as TS
from multimodaltopicsegmentation_torch.dsp import vad as TV
from multimodaltopicsegmentation_torch.dsp import yin as TY

SR = 16000


def _signal(kind, n, rng):
    t = np.arange(n) / SR
    if kind.startswith("sine"):
        return 0.5 * np.sin(2 * np.pi * float(kind[4:]) * t)
    if kind == "glide":  # 110 -> 220 Hz over the row
        f = 110.0 * 2.0 ** (t / max(t[-1], 1e-3))
        return 0.5 * np.sin(2 * np.pi * np.cumsum(f) / SR)
    if kind == "noise":
        return 0.3 * rng.standard_normal(n)
    return np.zeros(n)


def ragged_batch(seed=0):
    """-> ([U, S] float32 rows, [U] int32 lengths): one row per kind."""
    rng = np.random.default_rng(seed)
    rows = [("sine110", 16000), ("sine220", 12000), ("sine330", 9000), ("glide", 14000),
            ("noise", 10000), ("silence", 8000), ("sine220", 500), ("silence", 0)]
    S = 18000
    units = np.zeros((len(rows), S), np.float32)
    for i, (kind, n) in enumerate(rows):
        units[i, :n] = _signal(kind, n, rng)
    return units, np.asarray([n for _, n in rows], np.int32)


def short_batch():
    """Rows of 500 samples: shorter than the 1024-sample reflect pad."""
    units = np.zeros((2, 500), np.float32)
    units[0] = _signal("sine220", 500, None)
    return units, np.asarray([500, 0], np.int32)


def _vjax(fn, *arrays):
    return np.asarray(jax.vmap(fn)(*[jnp.asarray(a) for a in arrays]))


def _t(a):
    return torch.from_numpy(np.array(a))


def _features_close(got, want):
    """atol and rtol 1e-4, plus two float32 ulps of each row's largest value."""
    ulps = 2 * np.spacing(np.abs(want).max(axis=1, keepdims=True).astype(np.float32))
    bad = np.abs(got - want) > 1e-4 + 1e-4 * np.abs(want) + ulps
    assert not bad.any(), (np.argwhere(bad)[:5], got[bad][:5], want[bad][:5])


def _row_close(got, want, rtol):
    """|got - want| <= rtol * max|want| of each row."""
    scale = np.abs(want).reshape(len(want), -1).max(axis=1)
    err = np.abs(got - want).reshape(len(want), -1).max(axis=1)
    assert (err <= rtol * np.maximum(scale, 1e-30)).all(), (err, scale)


@pytest.mark.parametrize("n,pad", [(1, 3), (2, 5), (5, 4), (500, 1024), (800, 1024), (9, 30)])
def test_reflect_index_matches_numpy_pad(n, pad):
    a = np.arange(n)
    assert (TS.reflect_index(n, pad, pad) == np.pad(a, (pad, pad), mode="reflect")).all()


@pytest.mark.parametrize("batch", [ragged_batch, short_batch])
def test_spectral_matches_jax(batch):
    units, _ = batch()
    y = _t(units)
    _row_close(TS.stft_power(y).numpy(), _vjax(lambda r: JS.stft_power(r), units), 1e-4)
    mel = _vjax(lambda r: JS.melspectrogram(r, SR, n_mels=40), units)
    _row_close(TS.melspectrogram(y, SR, n_mels=40).numpy(), mel, 1e-4)
    db = _vjax(lambda r: JS.power_to_db(JS.melspectrogram(r, SR, n_mels=64)), units)
    _row_close(TS.power_to_db(TS.melspectrogram(y, SR, n_mels=64)).numpy(), db, 1e-4)
    mf = _vjax(lambda r: JS.mfcc(r, SR, n_mfcc=50), units)
    got = TS.mfcc(y, SR, n_mfcc=50).numpy()
    _row_close(got, mf, 1e-4)
    np.testing.assert_allclose(TS.delta(_t(mf)).numpy(), np.asarray(JS.delta(jnp.asarray(mf))),
                               atol=1e-4, rtol=1e-6)


def test_power_to_db_clamps_per_row():
    """The top_db floor is taken under each row's own peak, never the batch's."""
    S = np.full((2, 3, 4), 1e-9, np.float32)
    S[0, 0, 0] = 1.0
    db = TS.power_to_db(_t(S)).numpy()
    assert db[0].min() == pytest.approx(-80.0) and db[1].min() == pytest.approx(-90.0)


def test_betainc_matches_scipy():
    from scipy.special import betainc

    x = np.concatenate([[0.0, 1.0, 1e-6, 1e-3], np.linspace(0, 1, 101)]).astype(np.float32)
    got = TY.betainc_2_18(_t(x)).numpy()
    np.testing.assert_allclose(got, betainc(2.0, 18.0, x.astype(np.float64)), atol=1e-6)


@pytest.mark.parametrize("batch", [ragged_batch, short_batch])
def test_yin_matches_jax(batch):
    units, _ = batch()
    frames = TS.frame_signal(_t(units), 2048, 512)
    cmndf, band, tau_min, tau_max = TY.cmndf_band(frames, SR, 70.0, 500.0)
    jframes = _vjax(lambda r: JS.frame_signal(r, 2048, 512), units)
    jc, jb, jmin, jmax = JY.cmndf_band(jnp.asarray(jframes.reshape(-1, 2048)), SR, 70.0, 500.0)
    assert (tau_min, tau_max) == (jmin, jmax)
    np.testing.assert_allclose(cmndf.numpy().reshape(jc.shape), np.asarray(jc), atol=2e-4)
    with jax.enable_x64(True):
        f64 = jframes.reshape(-1, 2048).astype(np.float64)
        want64 = np.asarray(JY.cmndf_band(jnp.asarray(f64), SR, 70.0, 500.0)[0])
    got64 = TY.cmndf_band(_t(f64), SR, 70.0, 500.0)[0].numpy()
    np.testing.assert_allclose(got64, want64, atol=1e-9)

    # the same CMNDF into both selectors: the same troughs, so f0 agrees to rounding
    f0, voicing = TY.select_f0(_t(np.asarray(jc)), _t(np.asarray(jb)), jmin, SR)
    jf0, jvoicing = JY.select_f0(jc, jb, jmin, SR)
    np.testing.assert_allclose(f0.numpy(), np.asarray(jf0), rtol=1e-6)
    np.testing.assert_allclose(voicing.numpy(), np.asarray(jvoicing), atol=1e-5)

    got_f0, got_v = TY.yin(_t(units), SR)
    want_f0, want_v = jax.vmap(lambda r: JY.yin(r, SR))(jnp.asarray(units))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5)
    assert (np.isnan(got_f0.numpy()) == np.isnan(np.asarray(want_f0))).all()


@pytest.mark.parametrize("batch", [ragged_batch, short_batch])
def test_pyin_matches_jax(batch):
    units, _ = batch()
    got = [a.numpy() for a in TPY.pyin(_t(units), SR, with_raw_yin=True)]
    want = [np.asarray(a) for a in
            jax.vmap(lambda r: JPY.pyin(r, SR, with_raw_yin=True))(jnp.asarray(units))]
    f0, flag, prob, raw = got
    np.testing.assert_array_equal(flag, want[1])
    # f0 is a bin-table lookup: equal values are equal Viterbi states
    np.testing.assert_array_equal(f0, want[0])
    np.testing.assert_allclose(prob, want[2], atol=1e-5)
    np.testing.assert_allclose(raw, want[3], rtol=1e-5)
    if batch is ragged_batch:
        assert flag[0].sum() > 20 and not flag[4].any()  # the sine is voiced, noise not


def _viterbi_loop(log_obs, log_A, p_init):
    """Plain per-frame Viterbi with first-index ties (numpy)."""
    T, n = log_obs.shape
    delta = p_init + log_obs[0]
    bps = []
    for t in range(1, T):
        cand = delta[:, None] + log_A
        bps.append(np.argmax(cand, axis=0))
        delta = cand.max(axis=0) + log_obs[t]
    states = [int(np.argmax(delta))]
    for bp in reversed(bps):
        states.append(int(bp[states[-1]]))
    return states[::-1]


def test_viterbi_matches_loop_with_ties():
    rng = np.random.default_rng(3)
    n = 12
    # small integers make exact ties common
    log_obs = rng.integers(-3, 1, (4, 9, n)).astype(np.float32)
    log_A = rng.integers(-2, 1, (n, n)).astype(np.float32)
    p_init = np.zeros(n, np.float32)
    got = TPY.viterbi(_t(log_obs), _t(log_A), _t(p_init)).numpy()
    for u in range(4):
        assert got[u].tolist() == _viterbi_loop(log_obs[u], log_A, p_init)


def _tracks():
    """Hand-built voicing tracks: completed pauses, a trailing open run only,
    no pause at all, everything paused, interleaved masked frames."""
    v = np.full((6, 12), 0.9, np.float32)
    v[0, [2, 3, 6, 10, 11]] = 0.1   # two completed pauses (2 and 1) + open run
    v[1, [8, 9, 10, 11]] = 0.2      # only a trailing open run
    v[3, :] = 0.3                   # all pause, open run of every valid frame
    v[4, [1, 2, 4]] = 0.4           # masked frame 3 sits inside a pause run
    v[5, [5]] = 0.0                 # pause at the last valid frame
    v[2] = np.linspace(0.5, 1.0, 12)  # no pause at all
    mask = np.ones((6, 12), np.float32)
    mask[4, 3] = 0.0
    mask[5, 6:] = 0.0
    return v, mask


def test_pause_statistics_matches_jax():
    v, mask = _tracks()
    got = np.stack([a.numpy() for a in TP.pause_statistics(_t(v), _t(mask))])
    want = np.stack([np.asarray(a) for a in jax.vmap(JP.pause_statistics)(jnp.asarray(v),
                                                                        jnp.asarray(mask))])
    np.testing.assert_array_equal(got, want)
    # the three branches: completed pauses, an open run only, no pause
    assert got[0, 0] == 1.5 and got[0, 1] == 4.0 and got[0, 2] == 0.0


@pytest.mark.parametrize("batch", [ragged_batch, short_batch])
def test_unit_features_match_jax(batch):
    units, lens = batch()
    got = TP.prosodic_features(_t(units), _t(lens), SR).numpy()
    want = np.asarray(JP.prosodic_features(jnp.asarray(units), jnp.asarray(lens), SR))
    assert got.shape == (len(units), 167)
    _features_close(got, want)
    got = TP.mfcc_features(_t(units), _t(lens), SR).numpy()
    _features_close(got, np.asarray(JP.mfcc_features(jnp.asarray(units), jnp.asarray(lens), SR)))


def _document(n_units=300, seed=5):
    """A ragged document of sentence-like units (tones with gaps) -> (audio, bounds)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2400, 5600, n_units)
    audio = (0.01 * rng.standard_normal(int(lengths.sum()))).astype(np.float32)
    bounds, start = [], 0
    for n in lengths:
        t = np.arange(n - 800) / SR
        audio[start : start + n - 800] += 0.4 * np.sin(2 * np.pi * rng.choice([120, 200, 310]) * t)
        bounds.append((start, start + int(n)))
        start += int(n)
    return audio, bounds


def test_encoders_cross_the_chunk_boundary_like_jax():
    """300 units: the prosodic chunk of 256 carries one unit of left context,
    so a chunked run equals an unchunked one and the JAX package's."""
    from multimodaltopicsegmentation_tpu.encoders.engine import MFCCEncoder as JM
    from multimodaltopicsegmentation_tpu.encoders.engine import ProsodicEncoder as JPE
    from multimodaltopicsegmentation_torch.encoders.engine import MFCCEncoder, ProsodicEncoder

    audio, bounds = _document()
    enc = ProsodicEncoder(device="cpu")
    got = np.stack(enc.encode_document(audio, bounds))
    np.testing.assert_allclose(np.stack(enc.encode_document(audio, bounds, chunk=512)), got,
                               atol=1e-5, rtol=1e-6)
    want = np.stack(JPE().encode_document(audio, bounds))
    assert got.shape == (300, 167) and np.abs(got[256:, -1]).max() > 0
    _features_close(got, want)
    got = np.stack(MFCCEncoder(device="cpu").encode_document(audio, bounds))
    _features_close(got, np.stack(JM().encode_document(audio, bounds)))


def _speechy(seconds=6.0, seed=7):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    audio = (0.003 * rng.standard_normal(n)).astype(np.float32)
    t = np.arange(n) / SR
    for a, b in ((0.4, 1.9), (2.3, 2.45), (2.8, 4.6), (5.0, 5.9)):
        sl = slice(int(a * SR), int(b * SR))
        audio[sl] += 0.3 * np.sin(2 * np.pi * 180 * t[sl])
    audio[int(3.5 * SR) : int(3.7 * SR)] *= 0.01  # a dip inside a span
    return audio


def test_frame_log_energy_matches_jax():
    audio = _speechy()
    got = TV.frame_log_energy(_t(audio), SR).numpy()
    np.testing.assert_allclose(got, np.asarray(JV.frame_log_energy(jnp.asarray(audio), SR)),
                               atol=1e-4)


@pytest.mark.parametrize("energy_vad", [True, False])
def test_speech_segments_identical(monkeypatch, energy_vad):
    monkeypatch.delenv("MTS_VAD_WEIGHTS", raising=False)
    audio = _speechy()
    got = TV.get_speech_segments(audio, SR, apply_energy_VAD=energy_vad, device="cpu")
    assert got == JV.get_speech_segments(audio, SR, apply_energy_VAD=energy_vad)
    assert len(got) >= 3
    assert TV.speech_segments(audio, SR, device="cpu") == JV.speech_segments(audio, SR)
    quartered = TV.get_speech_segments_quartered(audio, SR, device="cpu")
    assert quartered == JV.get_speech_segments_quartered(audio, SR)
