"""The port's front-end networks against the JAX package on the CPU, at full
published width with the JAX `*_init(PRNGKey(0))` weights carried over by
`from_jax_params`: x-vector, ECAPA-TDNN, OpenL3 (mel128 and mel256), CREPE,
and the CRDNN VAD posteriors; plus each npz loader against the JAX one on
the same file. Outputs agree within 1e-4 of their largest magnitude.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.encoders import crdnn_vad as JV
from multimodaltopicsegmentation_tpu.encoders import crepe as JC
from multimodaltopicsegmentation_tpu.encoders import openl3 as JO
from multimodaltopicsegmentation_tpu.encoders import tdnn as JT
from multimodaltopicsegmentation_torch.encoders import crdnn_vad as TV
from multimodaltopicsegmentation_torch.encoders import crepe as TC
from multimodaltopicsegmentation_torch.encoders import openl3 as TO
from multimodaltopicsegmentation_torch.encoders import tdnn as TT

SR = 16000


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=1e-4):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rel * max(np.abs(want).max(), 1e-6))


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * 190 * t) * (t % 1.0 < 0.7)
            + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def _bounds(n_samples):
    """Ragged units, one of 500 samples (shorter than the fbank's reflect pad)."""
    edges = [0, 16000, 16500, 30000, 41000, n_samples]
    return list(zip(edges[:-1], edges[1:]))


@pytest.mark.parametrize("kind", ["xvector", "ecapa"])
def test_tdnn_networks_match_jax(kind):
    init, apply, model, convert, n_mels = {
        "xvector": (JT.xvector_init, JT.xvector_apply, TT.XVector, TT.xvector_from_jax_params, 24),
        "ecapa": (JT.ecapa_init, JT.ecapa_apply, TT.ECAPA, TT.ecapa_from_jax_params, 80),
    }[kind]
    params = _np(init(jax.random.PRNGKey(0)))
    net = model().eval()
    net.load_state_dict(convert(params))
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((4, 120, n_mels)).astype(np.float32)
    mask = (np.arange(120)[None] < np.array([120, 80, 4, 1])[:, None]).astype(np.float32)
    want = np.asarray(jax.vmap(apply, in_axes=(None, 0, 0))(params, jnp.asarray(feats),
                                                            jnp.asarray(mask)))
    with torch.no_grad():
        got = net(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    _close(got, want)


@pytest.mark.parametrize("kind", ["xvector", "ecapa"])
def test_tdnn_encoders_match_jax(monkeypatch, kind):
    """Whole documents through fbank, bucketing and pooling, same weights."""
    monkeypatch.setenv("MTS_RANDOM_ENCODER_WEIGHTS", "1")
    for var in ("MTS_XVECTOR_WEIGHTS", "MTS_ECAPA_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    if kind == "xvector":
        params = _np(JT.xvector_init(jax.random.PRNGKey(0)))
        monkeypatch.setattr(TT, "xvector_random_state_dict",
                            lambda g: TT.xvector_from_jax_params(params))
        jenc, tenc = JT.XVectorEncoder(), TT.XVectorEncoder(device="cpu")
    else:
        params = _np(JT.ecapa_init(jax.random.PRNGKey(0)))
        monkeypatch.setattr(TT, "ecapa_random_state_dict",
                            lambda g: TT.ecapa_from_jax_params(params))
        jenc, tenc = JT.EcapaEncoder(), TT.EcapaEncoder(device="cpu")
    audio = _audio(3.2, 2)
    bounds = _bounds(len(audio))
    got, want = np.stack(tenc.encode_document(audio, bounds)), np.stack(jenc.encode_document(audio, bounds))
    assert got.shape == (len(bounds), tenc.dim)
    _close(got, want)


@pytest.mark.parametrize("n_mels", [128, 256])
def test_openl3_matches_jax(n_mels):
    params = _np(JO.openl3_init(jax.random.PRNGKey(0), n_mels))
    net = TO.OpenL3().eval()
    net.load_state_dict(TO.from_jax_params(params))
    rng = np.random.default_rng(3)
    windows = (0.3 * rng.standard_normal((2, 48000))).astype(np.float32)
    windows[1, 30000:] = 0.0  # a padded tail, as short units give
    want = np.asarray(JO.openl3_apply(params, jnp.asarray(windows), n_mels))
    with torch.no_grad():
        got = net(torch.from_numpy(windows), n_mels).numpy()
    _close(got, want)


def test_crepe_matches_jax():
    params = _np(JC.crepe_init(jax.random.PRNGKey(0)))
    net = TC.Crepe().eval()
    net.load_state_dict(TC.from_jax_params(params))
    rng = np.random.default_rng(4)
    frames = (0.3 * rng.standard_normal((6, 1024))).astype(np.float32)
    frames[5] = 0.0  # a bucketing row
    want = np.asarray(JC.crepe_apply(params, jnp.asarray(frames)))
    with torch.no_grad():
        got = net(torch.from_numpy(frames)).numpy()
    _close(got, want)


@pytest.mark.parametrize("n,k,s", [(1024, 512, 4), (128, 64, 1), (7, 3, 2), (5, 8, 1)])
def test_crepe_same_padding_matches_xla(n, k, s):
    x = np.arange(n, dtype=np.float32)[None, None, :]
    w = np.ones((1, 1, k), np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (s,), "SAME"))
    got = torch.nn.functional.conv1d(torch.nn.functional.pad(torch.from_numpy(x),
                                                             TC.same_padding(n, k, s)),
                                     torch.from_numpy(w), stride=s).numpy()
    np.testing.assert_array_equal(got, want)


def test_crdnn_posteriors_match_jax():
    params = JV.random_params(jax.random.PRNGKey(0))
    audio = _audio(3.0, 5)
    want = JV.posteriors(params, audio, SR)
    got = TV.posteriors(TV.build(_np(params), "cpu"), audio, SR)
    assert got.shape == want.shape == (1 + len(audio) // 160,)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert TV.posteriors(TV.build(_np(params), "cpu"), np.zeros(0, np.float32), SR).shape == (0,)


def test_crdnn_fbank_matches_jax():
    audio = _audio(1.3, 6)
    want = np.asarray(JV.vad_fbank(jnp.asarray(audio)))
    got = TV.vad_fbank(torch.from_numpy(audio)).numpy()
    _close(got, want)


def test_crdnn_random_params_schema_matches_jax():
    """The port's random_params writes the npz schema the JAX loader reads."""
    mine = TV.random_params(torch.Generator().manual_seed(0))
    theirs = _np(JV.random_params(jax.random.PRNGKey(0)))
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert np.shape(mine[k]) == np.shape(theirs[k]), k


def _flat_tdnn(prefix, p, out):
    out[f"{prefix}_w"], out[f"{prefix}_b"] = p["w"], p["b"]
    for k, v in p["bn"].items():
        out[f"{prefix}_bn_{k}"] = v


def _npz_cases(tmp_path):
    """-> {kind: (npz path, JAX loader, port loader)} from JAX init weights."""
    cases = {}
    x = _np(JT.xvector_init(jax.random.PRNGKey(0)))
    flat = {"emb_w": x["emb_w"], "emb_b": x["emb_b"]}
    for i, lp in enumerate(x["tdnn"]):
        _flat_tdnn(f"tdnn{i}", lp, flat)
    cases["xvector"] = (flat, JT.xvector_load_npz, TT.xvector_load_npz)

    e = _np(JT.ecapa_init(jax.random.PRNGKey(0)))
    flat = {"fc_w": e["fc_w"], "fc_b": e["fc_b"], "asp_conv_w": e["asp_conv"]["w"],
            "asp_conv_b": e["asp_conv"]["b"]}
    for name in ("stem", "mfa", "asp_tdnn"):
        _flat_tdnn(name, e[name], flat)
    for k, v in e["asp_bn"].items():
        flat[f"asp_bn_{k}"] = v
    for j, block in enumerate(e["blocks"]):
        _flat_tdnn(f"block{j}_tdnn1", block["tdnn1"], flat)
        _flat_tdnn(f"block{j}_tdnn2", block["tdnn2"], flat)
        for i, sub in enumerate(block["res2net"]):
            _flat_tdnn(f"block{j}_res2net{i}", sub, flat)
        for se in ("se1", "se2"):
            flat[f"block{j}_{se}_w"], flat[f"block{j}_{se}_b"] = block[se]["w"], block[se]["b"]
    cases["ecapa"] = (flat, JT.ecapa_load_npz, TT.ecapa_load_npz)

    o = _np(JO.openl3_init(jax.random.PRNGKey(0)))
    flat = {}
    for i, lp in enumerate(lp for block in o["blocks"] for lp in block):
        flat[f"conv{i}_w"], flat[f"conv{i}_b"] = lp["w"], lp["b"]
        for k, v in lp["bn"].items():
            flat[f"bn{i}_{k}"] = v
    cases["openl3"] = (flat, JO.load_weights, TO.load_weights)

    c = _np(JC.crepe_init(jax.random.PRNGKey(0)))
    flat = {"proj_w": c["proj_w"], "proj_b": c["proj_b"]}
    for i, lp in enumerate(c["layers"]):
        flat[f"conv{i}_w"], flat[f"conv{i}_b"] = lp["w"], lp["b"]
        for k, v in lp["bn"].items():
            flat[f"bn{i}_{k}"] = v
    cases["crepe"] = (flat, JC.load_weights, TC.load_weights)
    cases["crdnn_vad"] = (_np(JV.random_params(jax.random.PRNGKey(1))), JV.load_npz, TV.load_npz)

    for kind, (flat, jload, tload) in cases.items():
        path = os.path.join(tmp_path, f"{kind}.npz")
        np.savez(path, **flat)
        cases[kind] = (path, jload, tload)
    return cases


@pytest.mark.parametrize("kind", ["xvector", "ecapa", "openl3", "crepe", "crdnn_vad"])
def test_npz_loaders_read_what_jax_reads(tmp_path, kind):
    path, jload, tload = _npz_cases(str(tmp_path))[kind]
    want = jax.tree_util.tree_flatten_with_path(_np(jload(path)))[0]
    got = jax.tree_util.tree_flatten_with_path(tload(path))[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(k))


@pytest.mark.parametrize("kind", ["xvector", "ecapa", "openl3", "crepe"])
def test_explicit_weights_beat_random_mode(tmp_path, monkeypatch, kind):
    """MTS_*_WEIGHTS wins over MTS_RANDOM_ENCODER_WEIGHTS=1, as in JAX."""
    path, jload, _ = _npz_cases(str(tmp_path))[kind]
    monkeypatch.setenv("MTS_RANDOM_ENCODER_WEIGHTS", "1")
    var, make, convert = {
        "xvector": ("MTS_XVECTOR_WEIGHTS", lambda: TT.XVectorEncoder(device="cpu").model,
                    TT.xvector_from_jax_params),
        "ecapa": ("MTS_ECAPA_WEIGHTS", lambda: TT.EcapaEncoder(device="cpu").model,
                  TT.ecapa_from_jax_params),
        "openl3": ("MTS_OPENL3_WEIGHTS_MEL128", lambda: TO.OpenL3Encoder(device="cpu").model,
                   TO.from_jax_params),
        "crepe": ("MTS_CREPE_WEIGHTS", lambda: TC.CrepeEncoder(device="cpu").model,
                  TC.from_jax_params),
    }[kind]
    monkeypatch.setenv(var, path)
    state = make().state_dict()
    for k, v in convert(_np(jload(path))).items():
        assert torch.equal(state[k].cpu(), v), k


@pytest.mark.parametrize("dim,frame_level", [(512, False), (256, True)])
def test_weightless_encoder_matches_jax(monkeypatch, dim, frame_level):
    """The weightless stand-in: without random-weight mode both packages
    raise; with it both serve the same numpy-seeded projection of log-mel
    statistics (frame-level: each vector tiled over 4 frames)."""
    from multimodaltopicsegmentation_tpu.encoders import engine as JE
    from multimodaltopicsegmentation_torch.encoders import engine as TE

    audio = _audio(3.0, 5)
    bounds = _bounds(len(audio))
    monkeypatch.delenv("MTS_RANDOM_ENCODER_WEIGHTS", raising=False)
    for enc in (JE._WeightlessEncoder("openl3", dim, frame_level),
                TE._WeightlessEncoder("openl3", dim, frame_level, device="cpu")):
        with pytest.raises(RuntimeError, match="needs pretrained weights"):
            enc.encode_document(audio, bounds)
    monkeypatch.setenv("MTS_RANDOM_ENCODER_WEIGHTS", "1")
    want = JE._WeightlessEncoder("openl3", dim, frame_level).encode_document(audio, bounds)
    got = TE._WeightlessEncoder("openl3", dim, frame_level, device="cpu").encode_document(
        audio, bounds)
    assert len(got) == len(want) == len(bounds)
    for g, w in zip(got, want):
        assert g.shape == w.shape == ((4, dim) if frame_level else (dim,))
        _close(np.asarray(g), np.asarray(w))


# `engine.build_encoder`'s flag of each front-end encoder (none: the x-vector default)
FRONT_ENDS = ["xvector", "ecapa", "openl3", "CREPE", "prosodic_feats", "mfcc", "wav2vec"]


def _prosodic_states(audio, bounds, device):
    """pYIN's voiced flags and f0 of the prosodic encoder's padded units, and
    which frames lie inside a unit."""
    from multimodaltopicsegmentation_torch.dsp.pyin import pyin
    from multimodaltopicsegmentation_torch.encoders.engine_util import pad_units

    units, lens = pad_units(audio, bounds, bucket=True)
    f0, flag, _, _ = pyin(torch.from_numpy(units).to(device), SR, with_raw_yin=True)
    valid = np.arange(flag.shape[1])[None, :] < (1 + lens[:, None] // 512)
    return flag.cpu().numpy(), f0.cpu().numpy(), valid


@pytest.mark.cuda
@pytest.mark.parametrize("flag", FRONT_ENDS)
def test_cuda_front_end_encoder_matches_the_cpu(monkeypatch, flag):
    """Each encoder `engine.build_encoder` selects, in random-weight mode, on
    the card against the CPU over the ragged units of one document: within
    1e-4 of the largest magnitude. wav2vec2's one chunk launches K1 once and
    the 3xTF32 dense layer 4 x 12 + 1 times. Prosodic vectors: pYIN's state
    may differ on under 1 % of the frames, and a unit where it does is
    exempt in its six f0/pause/voicing columns and its pitch jump (which
    divides by that unit's f0)."""
    import argparse

    from multimodaltopicsegmentation_torch.encoders.engine import build_encoder
    from multimodaltopicsegmentation_torch.ops import instance_norm_gelu as K1
    from multimodaltopicsegmentation_torch.ops import linear_tf32x3 as LIN

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("MTS_RANDOM_ENCODER_WEIGHTS", "1")
    for var in ("MTS_XVECTOR_WEIGHTS", "MTS_ECAPA_WEIGHTS", "MTS_OPENL3_WEIGHTS",
                "MTS_OPENL3_WEIGHTS_MEL128", "MTS_CREPE_WEIGHTS", "MTS_WAV2VEC2_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    args = argparse.Namespace(**({} if flag == "xvector" else {flag: True}))
    audio = _audio(3.2, 2)
    bounds = _bounds(len(audio))
    K1.instance_norm_gelu.launches = LIN.linear_tf32x3.launches = 0
    got, want = ([np.atleast_2d(u) for u in build_encoder(args, d).encode_document(audio, bounds)]
                 for d in ("cuda", "cpu"))
    assert len(got) == len(want) == len(bounds)
    launches = (K1.instance_norm_gelu.launches, LIN.linear_tf32x3.launches)
    assert launches == ((1, 4 * 12 + 1) if flag == "wav2vec" else (0, 0))
    got, want = np.concatenate(got), np.concatenate(want)
    if flag != "prosodic_feats":
        _close(got, want)
        return
    (flag_c, f0_c, valid), (flag_h, f0_h, _) = (_prosodic_states(audio, bounds, d)
                                                for d in ("cuda", "cpu"))
    same_f0 = (f0_c == f0_h) | (np.isnan(f0_c) & np.isnan(f0_h))
    differ = valid & ((flag_c != flag_h) | ~same_f0)
    assert differ.sum() < 0.01 * valid.sum()
    keep = np.ones(got.shape, bool)
    keep[np.ix_(differ.any(axis=1), list(range(6)) + [166])] = False
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-4 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("vad", ["energy", "crdnn"])
def test_cuda_vad_matches_the_cpu(tmp_path, monkeypatch, vad):
    """The training extractor's VAD (`dsp.vad.get_speech_segments`) on the
    card and on the CPU. Its posteriors: the energy logistic, or the random
    CRDNN's, within 1e-5. Then its spans (the CRDNN's with the head scaled
    by 300 and its bias set so that the document's median frame scores 0.5:
    unscaled, every posterior sits within 0.01 of 0.5 and no span forms):
    as many on both, their edges within one 10 ms frame."""
    from multimodaltopicsegmentation_torch.dsp import vad as V

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    audio = _audio(6.0, 7)
    monkeypatch.delenv("MTS_VAD_WEIGHTS", raising=False)
    params = TV.random_params(torch.Generator().manual_seed(0))
    if vad == "crdnn":
        path = str(tmp_path / "vad.npz")
        np.savez(path, **params)
        monkeypatch.setenv("MTS_VAD_WEIGHTS", path)
    got, want = (V.default_posteriors(audio, SR, d) for d in ("cuda", "cpu"))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if vad == "crdnn":
        params["out_w"] = params["out_w"] * 300.0
        median = float(np.median(TV.posteriors(TV.build(params, "cpu"), audio, SR)))
        params["out_b"] = (params["out_b"] - np.log(median / (1.0 - median))).astype(np.float32)
        np.savez(str(tmp_path / "vad_scaled.npz"), **params)
        monkeypatch.setenv("MTS_VAD_WEIGHTS", str(tmp_path / "vad_scaled.npz"))
    spans = [V.get_speech_segments(audio, SR, device=d) for d in ("cuda", "cpu")]
    assert len(spans[0]) == len(spans[1]) > 0
    for a, b in zip(*spans):
        assert abs(a[0] - b[0]) <= 0.01 + 1e-9 and abs(a[1] - b[1]) <= 0.01 + 1e-9
