"""`Wav2Vec2Encoder.encode_document`'s chunk loop, run one chunk ahead through
two staging slots, against a plain per-chunk loop written here: the same
frames bit for bit (the same shapes reach the same kernels), for chunk sizes
2, 3 and 4, a ragged tail chunk, a one-chunk document, documents of five and
more chunks (each slot reused) and ragged unit lengths (the document-wide
padded length matters); the `ahead` count of each `.forward` span; the
slots' size, bounded by two chunks whatever the document's length. On the
card (marked `cuda`), the same comparison with the copies back held late by
a device spin, so that a slot read or refilled too early shows. The file
imports no JAX, as a file of card-only tests must not."""
import numpy as np
import pytest
import torch

from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W
from multimodaltopicsegmentation_torch.encoders.engine import Wav2Vec2Encoder
from multimodaltopicsegmentation_torch.encoders.engine_util import bucket_rows, pad_units
from multimodaltopicsegmentation_torch.utils import profiling

SR = 16000


def _encoder(device="cpu"):
    cfg = W.Wav2Vec2Config.tiny()
    enc = Wav2Vec2Encoder.__new__(Wav2Vec2Encoder)
    enc.device, enc.cfg = torch.device(device), cfg
    enc.model = W.build_model(cfg, W.random_state_dict(cfg, seed=0), enc.device)
    return enc


def _plain(enc, audio, bounds, chunk):
    """The loop without staging: the whole document padded at once, each
    chunk's tail bucketed to 32 rows (capped at the chunk), `model(u, l)[:nb]`
    brought back by a blocking copy, each unit's valid frames."""
    units, lens = pad_units(audio, bounds, bucket=True)
    out = []
    with torch.inference_mode():
        for i in range(0, len(bounds), chunk):
            nb = min(chunk, len(bounds) - i)
            u, l = bucket_rows(units[i : i + chunk], lens[i : i + chunk], 32, cap=chunk)
            u, l = torch.from_numpy(u).to(enc.device), torch.from_numpy(l).to(enc.device)
            frames = enc.model(u, l)[:nb].cpu().numpy()
            for row, n in zip(frames, lens[i : i + chunk]):
                out.append(row[: max(W.feature_extractor_output_length(enc.cfg, int(n)), 1)])
    return out


def _document(kind, chunk, rng):
    """(audio, bounds): `whole` 1-s units filling whole chunks (one padded
    length, no bucketing); `one_chunk` ragged units that fit in one chunk;
    `ragged` five chunks and a ragged tail of ragged units, an empty unit
    and one running past the audio's end among them."""
    if kind == "whole":
        n = 3 * chunk
        return rng.standard_normal(n * SR + SR // 2).astype(np.float32), \
            [(k * SR, (k + 1) * SR) for k in range(n)]
    n = chunk - 1 if kind == "one_chunk" else 5 * chunk + 1
    cuts = np.cumsum(rng.integers(200, 3000, size=n))
    audio = rng.standard_normal(int(cuts[-1])).astype(np.float32)
    bounds = [(int(a), int(b)) for a, b in zip(np.concatenate([[0], cuts[:-1]]), cuts)]
    if kind == "ragged":
        bounds[2] = (bounds[2][0], bounds[2][0])  # empty: length 1, all padding
        bounds[-1] = (bounds[-1][0], bounds[-1][1] + 700)  # past the audio's end
    return audio, bounds


def _assert_same(got, want):
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setenv("MTS_PROFILE", "1")
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("kind", ["whole", "one_chunk", "ragged"])
@pytest.mark.parametrize("chunk", [2, 3, 4])
def test_pipelined_frames_equal_the_plain_loop(traced, chunk, kind):
    enc = _encoder()
    audio, bounds = _document(kind, chunk, np.random.default_rng(chunk))
    got = enc.encode_document(audio, bounds, chunk=chunk)
    _assert_same(got, _plain(enc, audio, bounds, chunk))
    chunks = -(-len(bounds) // chunk)
    ahead = [r.counts["ahead"] for r in profiling.spans() if r.name == "encode_document.forward"]
    assert ahead == [0] + [1] * (chunks - 1)


def test_slots_are_reused_across_documents_and_bounded_by_two_chunks():
    enc = _encoder()
    rng = np.random.default_rng(7)
    audio, bounds = _document("ragged", 3, rng)
    enc.encode_document(audio, bounds, chunk=3)
    slots = enc._slots
    flat = [t.data_ptr() for slot in slots.flat for t in slot]
    # a longer document of the same padded length holds the same two slots
    long_bounds = bounds * 4
    got = enc.encode_document(audio, long_bounds, chunk=3)
    assert enc._slots is slots and [t.data_ptr() for s in slots.flat for t in s] == flat
    _assert_same(got, _plain(enc, audio, long_bounds, 3))
    S = pad_units(audio, bounds, bucket=True)[0].shape[1]
    T = W.feature_extractor_output_length(enc.cfg, S)
    assert len(slots.flat) == 2
    assert slots.sizes == (3 * S, 3, 3 * T * enc.cfg.hidden_size)
    # a larger chunk grows them; a smaller one afterwards is a view of them
    enc.encode_document(audio, bounds, chunk=4)
    assert slots.sizes == (4 * S, 4, 4 * T * enc.cfg.hidden_size)
    grown = [t.data_ptr() for s in slots.flat for t in s]
    _assert_same(enc.encode_document(audio, bounds, chunk=2), _plain(enc, audio, bounds, 2))
    assert [t.data_ptr() for s in slots.flat for t in s] == grown
    assert not any(t.is_pinned() for s in slots.flat for t in s)  # ordinary memory on the CPU


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [3, 32])
def test_pipelined_frames_equal_the_plain_loop_on_card_with_late_copies(cuda_device, chunk):
    enc = _encoder(cuda_device)
    audio, bounds = _document("ragged", chunk, np.random.default_rng(11))
    bounds = bounds + bounds[: chunk + 1]  # six whole chunks and a ragged tail
    want = _plain(enc, audio, bounds, chunk)
    model = enc.model

    def late(u, l):
        # a spin queued after the forward holds the chunk's copy back (and
        # everything queued after it) for some 20 ms
        frames = model(u, l)
        torch.cuda._sleep(40_000_000)
        return frames

    backwards = _plain(enc, audio, bounds[::-1], chunk)
    enc.model = late
    got = enc.encode_document(audio, bounds, chunk=chunk)
    _assert_same(got, want)
    assert all(t.is_pinned() for s in enc._slots.flat for t in s)
    # the slots hold the first document's last chunks: the next one must not see them
    _assert_same(enc.encode_document(audio, bounds[::-1], chunk=chunk), backwards)
