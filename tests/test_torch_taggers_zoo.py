"""The rest of the tagger zoo in the port (biLSTMCRF, Transformer-CRF,
BiLSTMLateFusion, SimpleBiLSTM, MLP, SheikhBiLSTM, SwitchBiLSTM in both
modes, and the auxiliary cosine loss on BiLSTM and late fusion) against the
JAX package's taggers, on numpy-seeded batches with ragged lengths and a
zero-length row, the same weights in both (`from_jax_params`), TF32 off,
dropout 0.

Tolerances: scores (logits, or the CRFs' Viterbi scores) 1e-5 and tags
identical; loss 1e-5, parameter gradients 1e-4; 20 Adam steps of the two
CRF taggers, losses and final parameters 1e-4 (but the attention key
biases, whose gradient is zero in exact arithmetic). The state dicts go through
the JAX package's reference-checkpoint converter to `to_jax_params()` leaf
for leaf (every tagger but Transformer-CRF, which the reference cannot
save)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.models import registry as jax_registry
from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_tpu.tools.convert_reference_checkpoint import convert_state_dict
from multimodaltopicsegmentation_tpu.train import loop as JLoop
from multimodaltopicsegmentation_torch.models import registry
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.train import loop as TLoop

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (id, architecture, config overrides)
CASES = [
    ("biLSTMCRF", "biLSTMCRF", dict(loss_fn="CrossEntropy")),
    ("Transformer-CRF", "Transformer-CRF", dict(hidden_dim=16, nheads=2, loss_fn="CrossEntropy")),
    ("BiLSTMLateFusion", "BiLSTMLateFusion", dict(embedding_dim2=6, loss_fn="CrossEntropy")),
    ("SimpleBiLSTM", "SimpleBiLSTM", dict(loss_fn="BinaryCrossEntropy")),
    ("MLP", "MLP", dict(loss_fn="BinaryCrossEntropy")),
    ("SheikhBiLSTM", "SheikhBiLSTM", dict(loss_fn="BinaryCrossEntropy")),
    ("SwitchBiLSTM-lstm", "SwitchBiLSTM", dict(switch="lstm", loss_fn="FocalLoss")),
    ("SwitchBiLSTM-dense", "SwitchBiLSTM", dict(switch="dense", loss_fn="CrossEntropy")),
    ("BiLSTM-cos", "BiLSTM", dict(cosine_loss=True, loss_fn="FocalLoss")),
    ("BiLSTMLateFusion-cos", "BiLSTMLateFusion",
     dict(embedding_dim2=6, cosine_loss=True, loss_fn="BinaryCrossEntropy")),
]
IDS = [c[0] for c in CASES]


def _cfgs(**kw):
    base = dict(embedding_dim=12, hidden_dim=8, num_layers=2)
    base.update(kw)
    return JaxTaggerConfig(**base), TaggerConfig(**base)


def _batch(seed=0, B=5, L=13, D=12, lengths=(13, 9, 0, 1, 6), crf=False):
    rng = np.random.default_rng(seed)
    lengths = np.array(lengths[:B], np.int32)
    tags = (rng.random((B, L)) < 0.3).astype(np.float32)
    tags[np.arange(L)[None, :] >= lengths[:, None]] = 0.0 if crf else -1.0
    return {"src_tokens": rng.standard_normal((B, L, D)).astype(np.float32),
            "src_tokens2": rng.standard_normal((B, L, 6)).astype(np.float32),
            "tgt_tokens": tags, "src_lengths": lengths,
            "domain": np.array([1, 0, 1, 0, 0][:B], np.int32), "n_real": B}


def _jax(jarch, architecture, params, b, what, threshold=0.5):
    x, lengths, tags = (jnp.asarray(b[k]) for k in ("src_tokens", "src_lengths", "tgt_tokens"))
    if what == "loss":
        if architecture == "SwitchBiLSTM":
            return jarch.loss(params, x, lengths, tags, jnp.asarray(b["domain"]))
        if architecture == "BiLSTMLateFusion":
            return jarch.loss(params, x, lengths, tags, x2=jnp.asarray(b["src_tokens2"]))
        return jarch.loss(params, x, lengths, tags)
    if architecture == "SwitchBiLSTM":
        return jarch.decode(params, x, lengths, jnp.asarray(b["domain"]), threshold)
    if architecture == "BiLSTMLateFusion":
        return jarch.decode(params, x, lengths, threshold, x2=jnp.asarray(b["src_tokens2"]))
    return jarch.decode(params, x, lengths, threshold)


def _torch(tagger, architecture, b, what, threshold=0.5, device="cpu"):
    x, lengths, tags, x2, dom = (torch.from_numpy(b[k]).to(device) for k in (
        "src_tokens", "src_lengths", "tgt_tokens", "src_tokens2", "domain"))
    if what == "loss":
        if architecture == "SwitchBiLSTM":
            return tagger.loss(x, lengths, tags, dom)
        if architecture == "BiLSTMLateFusion":
            return tagger.loss(x, lengths, tags, x2=x2)
        return tagger.loss(x, lengths, tags)
    if architecture == "SwitchBiLSTM":
        return tagger.decode(x, lengths, dom, threshold)
    if architecture == "BiLSTMLateFusion":
        return tagger.decode(x, lengths, threshold, x2=x2)
    return tagger.decode(x, lengths, threshold)


def _pair(architecture, kw, seed=0):
    jcfg, cfg = _cfgs(**kw)
    jarch = jax_registry.build(architecture, jcfg)
    params = jax.tree.map(np.asarray, jarch.init(jax.random.PRNGKey(seed)))
    tagger = registry.build(architecture, cfg)
    tagger.load_state_dict(type(tagger).from_jax_params(params))
    return jarch, params, tagger


def _valid(scores, lengths):
    """The units a decode is read on (a CRF's scores are one per document)."""
    if scores.ndim == 1:
        return scores
    return np.concatenate([scores[b, :n].reshape(-1) for b, n in enumerate(lengths)])


@pytest.mark.parametrize("name,architecture,kw", CASES, ids=IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_scores_and_tags_match_jax(name, architecture, kw, seed):
    jarch, params, tagger = _pair(architecture, kw, seed)
    b = _batch(seed, crf=architecture.endswith("CRF"))
    want_scores, want_tags = _jax(jarch, architecture, params, b, "decode")
    with torch.no_grad():
        scores, tags = _torch(tagger.eval(), architecture, b, "decode")
    lengths = b["src_lengths"]
    np.testing.assert_allclose(_valid(scores.numpy(), lengths),
                               _valid(np.asarray(want_scores), lengths), atol=1e-5, rtol=0)
    assert tags.dtype == torch.bool
    np.testing.assert_array_equal(tags.numpy(), np.asarray(want_tags))


@pytest.mark.parametrize("name,architecture,kw", CASES, ids=IDS)
def test_loss_and_gradients_match_jax(name, architecture, kw):
    jarch, params, tagger = _pair(architecture, kw, seed=2)
    b = _batch(3, crf=architecture.endswith("CRF"))
    want, want_grads = jax.value_and_grad(lambda p: _jax(jarch, architecture, p, b, "loss"))(params)
    got = _torch(tagger, architecture, b, "loss")
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=0)
    carried = registry.grads_from_jax(tagger, jax.tree.map(np.asarray, want_grads))
    assert list(carried) == [n for n, _ in tagger.named_parameters()]
    for n, p in tagger.named_parameters():
        assert p.grad is not None, n
        np.testing.assert_allclose(p.grad.numpy(), carried[n].numpy(), atol=1e-4, rtol=0, err_msg=n)


@pytest.mark.parametrize("architecture,kw", [
    ("biLSTMCRF", dict(loss_fn="CrossEntropy")),
    ("Transformer-CRF", dict(hidden_dim=16, nheads=2, loss_fn="CrossEntropy")),
])
def test_crf_adam_trajectory_matches_jax(tmp_path, architecture, kw):
    """20 Adam(eps 1e-7) steps of the JAX Trainer's step and the port's on two
    alternating batches padded with the CRF label 0."""
    jcfg, cfg = _cfgs(**kw)
    batches = [_batch(s, lengths=(13, 9, 4, 11, 6), crf=True) for s in (4, 5)]
    jt = JLoop.Trainer(architecture, jcfg, lr=1e-3, check_dir=str(tmp_path / "j"))
    params = jax.tree.map(np.asarray, jt.arch.init(jax.random.PRNGKey(1)))
    jt.tx = JLoop.make_optimizer("Adam", 1e-3)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = jt.tx.init(jparams)
    step = jt._train_step()
    want = []
    for i in range(20):
        b = batches[i % 2]
        jparams, opt_state, loss = step(jparams, opt_state, jnp.asarray(b["src_tokens"]),
                                        jnp.asarray(b["src_lengths"]), jnp.asarray(b["tgt_tokens"]),
                                        None, {})
        want.append(float(loss))

    tt = TLoop.Trainer(architecture, cfg, lr=1e-3, check_dir=str(tmp_path / "t"), device="cpu")
    tt._setup(params)
    dev = TLoop.batches_to_device(batches, "cpu")
    got = [tt._train_step(dev[i % 2]).item() for i in range(20)]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[-1] < got[0]
    final = tt.tagger.state_dict()
    want_sd = type(tt.tagger).from_jax_params(jax.tree.map(np.asarray, jparams))
    assert set(want_sd) == set(final)
    start = type(tt.tagger).from_jax_params(params)
    for k, v in final.items():
        if k.endswith("attention.self.key.bias"):
            # the key bias shifts every score of a query alike, so softmax
            # cancels it: its gradient is rounding noise in both packages,
            # which Adam scales to steps of up to lr each
            assert (v - start[k]).abs().max() <= 20 * 1e-3 * (1 + 1e-3)
            continue
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("name,architecture,kw",
                         [c for c in CASES if c[1] != "Transformer-CRF"],
                         ids=[c[0] for c in CASES if c[1] != "Transformer-CRF"])
def test_state_dict_through_the_reference_converter(name, architecture, kw):
    """The port's state dict, under the reference Lightning prefix, converts
    with the JAX package's converter to the port's own JAX pytree."""
    _, cfg = _cfgs(**kw)
    tagger = registry.build(architecture, cfg, torch.Generator().manual_seed(0))
    sd = {f"model.{k}": v for k, v in tagger.state_dict().items()}
    params, jcfg, got_name = convert_state_dict(sd, architecture)
    assert got_name == architecture
    assert (jcfg.hidden_dim, jcfg.num_layers) == (cfg.hidden_dim, cfg.num_layers)
    flat_c, tree_c = jax.tree.flatten(jax.tree.map(np.asarray, params))
    flat_p, tree_p = jax.tree.flatten(tagger.to_jax_params())
    assert tree_c == tree_p
    for a, b in zip(flat_c, flat_p):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,architecture,kw", CASES, ids=IDS)
def test_jax_pytree_round_trip_and_seeded_init(name, architecture, kw):
    """to_jax_params -> from_jax_params gives the same state dict; one seed
    draws the same weights."""
    _, cfg = _cfgs(**kw)
    a = registry.build(architecture, cfg, torch.Generator().manual_seed(3))
    b = registry.build(architecture, cfg, torch.Generator().manual_seed(3))
    back = type(a).from_jax_params(a.to_jax_params())
    assert set(back) == set(a.state_dict())
    for k, v in a.state_dict().items():
        assert torch.equal(back[k], v) and torch.equal(b.state_dict()[k], v), k


def test_registry_names_and_kinds_match_jax():
    names = ("biLSTMCRF", "BiLSTM", "BiLSTMLateFusion", "SimpleBiLSTM", "MLP", "SheikhBiLSTM",
             "SwitchBiLSTM", "Transformer", "Transformer-CRF", "RecurrentLongT5",
             "BiLSTMRestrictedMHA", "RecurrentLongformer")
    for n in names:
        assert registry.is_crf(n) == jax_registry.is_crf(n)
        assert registry.is_double_input(n) == jax_registry.is_double_input(n)
        assert registry.is_domain_adapt(n) == jax_registry.is_domain_adapt(n)
    jcfg, cfg = _cfgs(embedding_dim2=6, nheads=2, attention_window=4)
    for n in names:
        assert type(registry.build(n, cfg)).__name__ == type(jax_registry.build(n, jcfg)).__name__


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,architecture,kw", CASES, ids=IDS)
def test_cuda_matches_the_cpu(cuda_device, name, architecture, kw):
    """Each tagger on the card against itself on the CPU: scores 1e-4, tags
    identical, loss and gradient norm 1e-4."""
    _, _, tagger = _pair(architecture, kw, seed=5)
    b = _batch(6, crf=architecture.endswith("CRF"))
    out = {}
    for device in ("cpu", cuda_device):
        tagger.to(device).zero_grad()
        with torch.no_grad():
            scores, tags = _torch(tagger.eval(), architecture, b, "decode", device=device)
        loss = _torch(tagger, architecture, b, "loss", device=device)
        loss.backward()
        norm = torch.sqrt(sum((p.grad * p.grad).sum() for p in tagger.parameters()))
        out[str(device)] = (scores.cpu().numpy(), tags.cpu().numpy(), loss.item(), norm.item())
    cpu, card = out["cpu"], out[str(cuda_device)]
    lengths = b["src_lengths"]
    np.testing.assert_allclose(_valid(card[0], lengths), _valid(cpu[0], lengths), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_allclose(card[2:], cpu[2:], atol=1e-4, rtol=0)


def test_config_fields_match_jax():
    """The port's TaggerConfig carries every field the zoo reads."""
    jf = {f.name for f in dataclasses.fields(JaxTaggerConfig)}
    assert {f.name for f in dataclasses.fields(TaggerConfig)} == jf
