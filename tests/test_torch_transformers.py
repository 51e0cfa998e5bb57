"""Port transformer taggers (models/transformers.py) against the JAX
package: the same numpy-seeded batch and the same weights (carried over with
`from_jax_params`) through both `decode`s on the CPU, TF32 off.

Logits agree within 1e-4 on valid positions (float32 summation order through
two layers; padded positions differ by design between the JAX blocked path
and nothing the taggers' outputs use), the tags are identical, and
`to_jax_params(from_jax_params(p))` gives `p` back exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodaltopicsegmentation_tpu.models import registry as jax_registry
from multimodaltopicsegmentation_tpu.models import transformers as JT
from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_tpu.tools.convert_reference_checkpoint import convert_state_dict
from multimodaltopicsegmentation_tpu.train import checkpoints as jax_ckpt
from multimodaltopicsegmentation_torch.models import registry
from multimodaltopicsegmentation_torch.models import transformers as TT
from multimodaltopicsegmentation_torch.models.base import TaggerConfig
from multimodaltopicsegmentation_torch.train import checkpoints as ckpt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4
ARCHITECTURES = ["Transformer", "RecurrentLongT5", "BiLSTMRestrictedMHA", "RecurrentLongformer"]


def _cfgs(**kw):
    base = dict(embedding_dim=32, hidden_dim=32, num_layers=2, nheads=4, attention_window=4,
                loss_fn="FocalLoss")
    base.update(kw)
    return JaxTaggerConfig(**base), TaggerConfig(**base)


def _batch(seed=0, B=4, L=21, D=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    lengths = np.array([L, 13, 1, 6][:B], np.int32)
    return x, lengths


def _jax_params(arch, seed=0):
    """Random JAX params as numpy, the head spread out so that some units
    score above the threshold."""
    params = jax.tree.map(np.asarray, arch.init(jax.random.PRNGKey(seed)))
    params["cls"]["w"] = params["cls"]["w"] * 20.0
    return params


def _check_decode(jarch, port, params, x, lengths):
    want_logits, want_tags = jarch.decode(params, jnp.asarray(x), jnp.asarray(lengths), 0.5)
    port.load_state_dict(type(port).from_jax_params(params))
    with torch.no_grad():
        logits, tags = port.eval().decode(torch.from_numpy(x), torch.from_numpy(lengths), 0.5)
    assert logits.shape == tuple(np.asarray(want_logits).shape)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(logits[b, :n].numpy(), np.asarray(want_logits)[b, :n], atol=ATOL)
        np.testing.assert_array_equal(tags[b, :n].numpy(), np.asarray(want_tags)[b, :n])
    assert np.isfinite(logits.numpy()).all()  # padded rows too
    return np.asarray(want_tags)


def _assert_trees_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("architecture", ARCHITECTURES)
@pytest.mark.parametrize("window", [4, 8])
def test_tagger_matches_jax(architecture, window):
    jcfg, cfg = _cfgs(attention_window=window)
    jarch = jax_registry.build(architecture, jcfg)
    params = _jax_params(jarch)
    x, lengths = _batch()
    # put the threshold between two of the full row's scores (not ON the
    # median one, which rounding could tip), so that both tags occur
    logits, _ = jarch.decode(params, jnp.asarray(x), jnp.asarray(lengths), 0.5)
    ordered = np.sort(np.asarray(logits)[0, :, 0])
    params["cls"]["b"] = params["cls"]["b"] - 0.5 * (ordered[10] + ordered[11])
    tags = _check_decode(jarch, registry.build(architecture, cfg), params, x, lengths)
    assert tags[0].any() and not tags[0].all()  # both tags occur


@pytest.mark.parametrize("architecture", ARCHITECTURES)
def test_jax_params_roundtrip(architecture):
    jcfg, cfg = _cfgs()
    params = _jax_params(jax_registry.build(architecture, jcfg), seed=1)
    port = registry.build(architecture, cfg)
    port.load_state_dict(type(port).from_jax_params(params))
    _assert_trees_equal(port.to_jax_params(), params)


def test_dense_transformer_matches_jax():
    """attention_window = 0 encodes the dense (restricted=False) variant."""
    jcfg, cfg = _cfgs(attention_window=0, loss_fn="CrossEntropy", embedding_dim=64)
    jarch = jax_registry.build("Transformer", jcfg)
    port = registry.build("Transformer", cfg)
    assert port.model.model.windows is None and jarch.encoder.windows is None
    x, lengths = _batch(seed=2, D=64)
    _check_decode(jarch, port, _jax_params(jarch, seed=2), x, lengths)


def test_pyramidal_windows():
    assert TT.pyramidal_windows(120, 2) == JT.pyramidal_windows(120, 2) == [240, 120]
    assert TT.pyramidal_windows(5, 3) == JT.pyramidal_windows(5, 3)


@pytest.mark.parametrize("sep_fb,last_bilstm,window", [(False, True, 4), (True, False, 4),
                                                       (True, True, 5)])
def test_recurrent_longformer_variants_match_jax(sep_fb, last_bilstm, window):
    """The fused (sep_fb=False) block, no final BiLSTM, and an odd window
    (rounded up to 6)."""
    jcfg, cfg = _cfgs(attention_window=window, loss_fn="BinaryCrossEntropy")
    jarch = JT.RecurrentLongformer(jcfg, sep_fb, last_bilstm)
    port = TT.RecurrentLongformer(cfg, sep_fb, last_bilstm)
    assert port.window == jarch.window
    params = _jax_params(jarch, seed=3)
    x, lengths = _batch(seed=3)
    _check_decode(jarch, port, params, x, lengths)
    _assert_trees_equal(port.to_jax_params(), params)


def test_longt5_encoder_geometry():
    enc = TT.LongT5Encoder(32, 4, 1, 32, window=120)
    ref = JT.LongT5Encoder(32, 4, 1, 32, 120, 0.0)
    assert (enc.window, enc.num_buckets, enc.max_distance) == (240, 120, 121)
    assert (ref.window, ref.num_buckets, ref.max_distance) == (240, 120, 121)
    assert TT.LongT5Encoder(32, 4, 1, 32, window=2).num_buckets == 4


@pytest.mark.parametrize("architecture", ["RecurrentLongT5", "BiLSTMRestrictedMHA"])
def test_state_dict_through_reference_converter(architecture):
    """The port's state_dict under the reference Lightning prefix converts
    with the JAX package's converter and scores the same there. The
    reference's T5 linears carry no biases, so they are zeroed first."""
    _, cfg = _cfgs(loss_fn="BinaryCrossEntropy")
    port = registry.build(architecture, cfg, torch.Generator().manual_seed(0)).eval()
    sd = port.state_dict()
    if architecture == "RecurrentLongT5":
        with torch.no_grad():
            for k, v in sd.items():
                if ".transformer." in k and k.endswith(".bias"):
                    v.zero_()
        sd = {k: v for k, v in sd.items() if not (".transformer." in k and k.endswith(".bias"))}
    params, jcfg, name = convert_state_dict({f"model.{k}": v for k, v in sd.items()},
                                            architecture)
    assert name == architecture
    jcfg = dataclasses.replace(jcfg, nheads=cfg.nheads, attention_window=cfg.attention_window)
    x, lengths = _batch(seed=4)
    want, _ = jax_registry.build(name, jcfg).decode(params, jnp.asarray(x), jnp.asarray(lengths), 0.5)
    with torch.no_grad():
        got, _ = port.decode(torch.from_numpy(x), torch.from_numpy(lengths), 0.5)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(want)[b, :n], atol=ATOL)


@pytest.mark.parametrize("architecture", ARCHITECTURES)
def test_checkpoints_interchange(tmp_path, architecture):
    """A JAX-written checkpoint loads into the port, and a port-written one
    loads into the JAX package, leaves unchanged."""
    jcfg, cfg = _cfgs()
    params = _jax_params(jax_registry.build(architecture, jcfg), seed=5)
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save(path, params, jcfg, architecture)
    got_params, got_cfg, name, _ = ckpt.load(path)
    assert name == architecture
    port = registry.build(name, got_cfg)
    port.load_state_dict(type(port).from_jax_params(got_params))
    out = str(tmp_path / "port.ckpt")
    ckpt.save(out, port.to_jax_params(), got_cfg, name)
    back, back_cfg, back_name, _ = jax_ckpt.load(out)
    assert back_name == architecture and back_cfg == jcfg
    _assert_trees_equal(back, params)


def test_positional_table_limits_the_length():
    _, cfg = _cfgs()
    port = TT.TransformerSegmenter(cfg)
    with pytest.raises(ValueError, match="positional table"):
        port.scores(torch.zeros(1, TT.MAX_POSITION + 1, 32), torch.tensor([5]))


def test_registry_flags_match_jax():
    for name in ARCHITECTURES + ["BiLSTM", "biLSTMCRF", "Transformer-CRF", "BiLSTMLateFusion",
                                 "SwitchBiLSTM"]:
        assert registry.is_crf(name) == jax_registry.is_crf(name)
        assert registry.is_double_input(name) == jax_registry.is_double_input(name)
        assert registry.is_domain_adapt(name) == jax_registry.is_domain_adapt(name)


# -- on the card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("architecture", ARCHITECTURES[:3])
def test_tagger_on_card_goes_through_the_flash_kernel(architecture):
    """On cuda each tagger's attention launches K2 (once per layer) and its
    logits agree with the CPU's (the blocked path) on valid positions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from multimodaltopicsegmentation_torch.ops import flash_attention as FA

    _, cfg = _cfgs(attention_window=8, embedding_dim=64, hidden_dim=64)
    port = registry.build(architecture, cfg, torch.Generator().manual_seed(0)).eval()
    x, lengths = _batch(seed=6, L=50, D=64)
    with torch.no_grad():
        want = port.scores(torch.from_numpy(x), torch.from_numpy(lengths))
        before = FA._flash_fwd.launches
        got = port.cuda().scores(torch.from_numpy(x).cuda(), torch.from_numpy(lengths).cuda())
    torch.cuda.synchronize()
    assert FA._flash_fwd.launches == before + cfg.num_layers
    for b, n in enumerate(lengths):
        torch.testing.assert_close(got[b, :n].cpu(), want[b, :n], atol=1e-3, rtol=1e-3)
