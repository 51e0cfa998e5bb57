"""The port's linear-chain CRF (multimodaltopicsegmentation_torch/ops/crf.py)
against the JAX package's ops/crf.py on numpy-seeded inputs, and against a
brute-force enumeration of every tag path.

Tolerances: forward algorithm, gold score, loss and Viterbi scores 1e-5
(float32 sums of a few terms around the -1e4 walls); gradients 1e-5; Viterbi
paths identical, positions past each length included.
"""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.ops import crf as JC
from multimodaltopicsegmentation_torch.ops import crf as TC

ATOL = 1e-5


def _case(seed=0, B=5, L=9, D=6, num_tags=2, lengths=(9, 4, 0, 1, 7)):
    """JAX CRF parameters (numpy leaves), features, ragged lengths with a
    zero-length row, and tags padded with -1."""
    params = jax.tree.map(np.asarray, JC.crf_params(jax.random.PRNGKey(seed), D, num_tags))
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, L, D)).astype(np.float32)
    lengths = np.array(lengths[:B], np.int32)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    tags = rng.integers(0, num_tags, (B, L)).astype(np.int32)
    tags[mask == 0] = -1
    return params, feats, mask, tags


def _port(params, D, num_tags):
    crf = TC.CRF(D, num_tags)
    sd = {}
    TC.from_jax_params(sd, "crf", params)
    crf.load_state_dict({k[len("crf."):]: v for k, v in sd.items()})
    return crf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_algorithm_and_gold_score_match_jax(seed):
    params, feats, mask, tags = _case(seed)
    safe = np.maximum(tags, 0)
    emissions = feats @ params["fc_w"] + params["fc_b"]
    want_z = JC.forward_algorithm(params, jnp.asarray(emissions), jnp.asarray(mask))
    want_g = JC.gold_score(params, jnp.asarray(emissions), jnp.asarray(safe), jnp.asarray(mask))
    trans = torch.tensor(params["transitions"])
    e, m = torch.from_numpy(emissions), torch.from_numpy(mask)
    np.testing.assert_allclose(TC.forward_algorithm(trans, e, m).numpy(), np.asarray(want_z),
                               atol=ATOL, rtol=0)
    got_g = TC.gold_score(trans, e, torch.from_numpy(safe), m).numpy()
    np.testing.assert_allclose(got_g, np.asarray(want_g), atol=ATOL, rtol=0)
    # a zero-length row scores the move START -> STOP alone
    C = params["transitions"].shape[0]
    assert got_g[2] == params["transitions"][C - 1, C - 2]


@pytest.mark.parametrize("num_tags,holes", [(2, False), (3, False), (2, True)])
def test_crf_loss_and_gradients_match_jax(num_tags, holes):
    """holes: a mask that is no prefix (units skipped inside a row), which the
    forward algorithm carries across as JAX's does."""
    params, feats, mask, tags = _case(3, num_tags=num_tags)
    if holes:
        mask[0, [2, 3, 6]] = 0.0
        mask[4, 0] = 0.0
    safe = np.maximum(tags, 0)
    want, grads = jax.value_and_grad(
        lambda p, f: JC.crf_loss(p, f, jnp.asarray(safe), jnp.asarray(mask)), argnums=(0, 1))(
            params, jnp.asarray(feats))
    crf = _port(params, feats.shape[-1], num_tags)
    f = torch.from_numpy(feats).requires_grad_()
    got = TC.crf_loss(crf, f, torch.from_numpy(safe), torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=0)
    jgrad_params, jgrad_feats = jax.tree.map(np.asarray, grads)
    np.testing.assert_allclose(f.grad.numpy(), jgrad_feats, atol=ATOL, rtol=0)
    np.testing.assert_allclose(crf.fc.weight.grad.numpy(), jgrad_params["fc_w"].T, atol=ATOL, rtol=0)
    np.testing.assert_allclose(crf.fc.bias.grad.numpy(), jgrad_params["fc_b"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(crf.transitions.grad.numpy(), jgrad_params["transitions"],
                               atol=ATOL, rtol=0)


def test_loss_ignores_zero_length_rows():
    """The mean runs over the documents with a valid unit only."""
    params, feats, mask, tags = _case(4)
    crf = _port(params, feats.shape[-1], 2)
    safe = torch.from_numpy(np.maximum(tags, 0))
    keep = [0, 1, 3, 4]
    with torch.no_grad():
        all_rows = TC.crf_loss(crf, torch.from_numpy(feats), safe, torch.from_numpy(mask))
        real = TC.crf_loss(crf, torch.from_numpy(feats[keep]), safe[keep], torch.from_numpy(mask[keep]))
    np.testing.assert_allclose(all_rows.item(), real.item(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_viterbi_scores_and_paths_match_jax(seed):
    params, feats, mask, _ = _case(seed, B=6, L=15, lengths=(15, 1, 0, 8, 14, 3))
    want_score, want_paths = JC.viterbi_decode(params, jnp.asarray(feats), jnp.asarray(mask))
    crf = _port(params, feats.shape[-1], 2)
    with torch.no_grad():
        score, paths = TC.viterbi_decode(crf, torch.from_numpy(feats), torch.from_numpy(mask))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), atol=ATOL, rtol=0)
    # identical everywhere: past each length both hold the last valid tag
    np.testing.assert_array_equal(paths.numpy(), np.asarray(want_paths))


def test_viterbi_with_the_walls_tied_matches_jax():
    """Emissions that put START and STOP at the IMPOSSIBLE walls, and equal
    real-tag scores, give ties at every step: first-index argmax in both."""
    params, feats, mask, _ = _case(5, B=3, L=7, lengths=(7, 5, 0))
    params = dict(params, fc_w=np.zeros_like(params["fc_w"]),
                  fc_b=np.array([0.0, 0.0, -1e4, -1e4], np.float32),
                  transitions=np.where(params["transitions"] <= -1e4, -1e4, 0.0).astype(np.float32))
    want_score, want_paths = JC.viterbi_decode(params, jnp.asarray(feats), jnp.asarray(mask))
    crf = _port(params, feats.shape[-1], 2)
    with torch.no_grad():
        score, paths = TC.viterbi_decode(crf, torch.from_numpy(feats), torch.from_numpy(mask))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(want_paths))


def _brute_force(trans, emissions, length, num_real_tags):
    """-> (log-partition over every path of the full tag set, best path over
    the real tags and its score)."""
    C = trans.shape[0]
    start, stop = C - 2, C - 1

    def path_score(path):
        s, prev = 0.0, start
        for t, tag in enumerate(path):
            s += trans[tag, prev] + emissions[t, tag]
            prev = tag
        return s + trans[stop, prev]

    full = np.array([path_score(p) for p in itertools.product(range(C), repeat=length)])
    log_z = full.max() + np.log(np.exp(full - full.max()).sum())
    real = {p: path_score(p) for p in itertools.product(range(num_real_tags), repeat=length)}
    best = max(real, key=real.get)
    return log_z, best, real[best]


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_forward_and_viterbi_match_enumeration(seed):
    """Every path of 2 real tags over up to 5 units, in float64 on the host."""
    params, feats, mask, _ = _case(seed, B=3, L=5, D=4, lengths=(5, 3, 4))
    crf = _port(params, 4, 2)
    with torch.no_grad():
        emissions = crf.fc(torch.from_numpy(feats))
        log_z = TC.forward_algorithm(crf.transitions, emissions, torch.from_numpy(mask))
        score, paths = TC.viterbi_decode(crf, torch.from_numpy(feats), torch.from_numpy(mask))
    trans = params["transitions"].astype(np.float64)
    for b, n in enumerate((5, 3, 4)):
        want_z, want_path, want_score = _brute_force(trans, emissions[b].double().numpy(), n, 2)
        assert log_z[b].item() == pytest.approx(want_z, rel=1e-5)
        assert score[b].item() == pytest.approx(want_score, rel=1e-5)
        assert tuple(paths[b, :n].tolist()) == want_path
        assert (paths[b, n:] == paths[b, n - 1]).all()


def test_init_has_the_walls_and_draws_from_the_generator():
    a = TC.CRF(8, 2, torch.Generator().manual_seed(0))
    b = TC.CRF(8, 2, torch.Generator().manual_seed(0))
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)
    assert a.transitions.shape == (4, 4)
    assert (a.transitions[2, :] == TC.IMPOSSIBLE).all() and (a.transitions[:, 3] == TC.IMPOSSIBLE).all()
    assert a.fc.weight.abs().max() <= 1 / np.sqrt(8)
    sd = {}
    TC.from_jax_params(sd, "crf", TC.to_jax_params({f"crf.{k}": v for k, v in a.state_dict().items()},
                                                   "crf"))
    for k, v in a.state_dict().items():
        assert torch.equal(sd[f"crf.{k}"], v)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_viterbi_and_loss_match_the_cpu(cuda_device):
    params, feats, mask, tags = _case(6, B=6, L=40, lengths=(40, 1, 0, 33, 17, 40))
    crf = _port(params, feats.shape[-1], 2)
    safe = torch.from_numpy(np.maximum(tags, 0))
    f, m = torch.from_numpy(feats), torch.from_numpy(mask)
    with torch.no_grad():
        cpu = TC.viterbi_decode(crf, f, m), TC.crf_loss(crf, f, safe, m)
        crf.to(cuda_device)
        f, m, safe = f.to(cuda_device), m.to(cuda_device), safe.to(cuda_device)
        card = TC.viterbi_decode(crf, f, m), TC.crf_loss(crf, f, safe, m)
    np.testing.assert_allclose(card[0][0].cpu().numpy(), cpu[0][0].numpy(), atol=1e-4, rtol=0)
    assert torch.equal(card[0][1].cpu(), cpu[0][1])
    np.testing.assert_allclose(card[1].item(), cpu[1].item(), atol=1e-4)
