"""The 3xTF32 dense layer (`ops/linear_tf32x3.py`, `csrc/linear_tf32x3.cu`)
and its use by the wav2vec2 and WavLM encoders.

On the CPU, at tiny shapes: the weight split is exact; the 3-product sum,
emulated on the rounded and truncated bits, lies within float32-class error
of float64 where one TF32 pass does not; the CPU path is `F.linear` (then
`F.gelu`) bit for bit; the encoder's cached operands follow its parameters;
Q, K and V as one product give the three projections.

On the card (marked `cuda`): the kernel against float64 at every (K, N) of
wav2vec2-base and WavLM-Large at the main path's row counts, the same
products in one TF32 pass failing the same tolerance; both encoders at full
width against the tests' plain reference; 4 L + 1 launches a forward. No JAX
here.

The error measure is the worst element's |y - y64| over (|x| |w|^T + |b|),
the scale of the rounding a float32 dot product can make; float32 GEMMs
read some 1e-7 to 5e-7 on normal inputs, one TF32 pass 3e-5 to 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodaltopicsegmentation_torch.encoders import wav2vec2 as W
from multimodaltopicsegmentation_torch.ops import linear_tf32x3 as L
import plain_wavlm  # tests/plain_wavlm.py: pytest puts this file's directory on sys.path

TOL = 2e-6  # float32-class: the kernel reads 0.6-2.3e-7 on the card, one TF32 pass 3e-5 or more


def scaled_error(y, x, w, b, gelu=False):
    x, w, b = x.double(), w.double(), b.double()
    want = x @ w.T + b
    if gelu:
        want = F.gelu(want)
    return ((y.double() - want).abs() / (x.abs() @ w.abs().T + b.abs())).max().item()


def operands(M, N, K, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    w = torch.randn(N, K, generator=g) * K ** -0.5
    b = 0.1 * torch.randn(N, generator=g)
    return x.to(device), w.to(device), b.to(device)


# -- CPU ------------------------------------------------------------------------------

def test_split_is_exact_and_rounds_to_nearest_tf32():
    g = torch.Generator().manual_seed(0)
    w = torch.cat([torch.randn(4000, generator=g) * 10.0 ** torch.randint(-30, 30, (4000,), generator=g),
                   torch.tensor([0.0, -0.0, 1.0, -1.0, 1e-40, -3e38, 2.0 ** -126])])
    big, small = L.split_tf32(w)
    assert torch.equal(big + small, w)
    bits = w.numpy().view(np.uint32)
    want = ((bits.astype(np.uint64) + 0x1000) & 0xffffe000).astype(np.uint32)  # to_tf32
    assert np.array_equal(big.numpy().view(np.uint32), want)
    normal = big.abs() >= 2.0 ** -126
    assert (small.abs() <= big.abs() * 2.0 ** -11)[normal].all()  # half a TF32 ulp at most


@pytest.mark.parametrize("M, N, K", [(37, 24, 16), (98, 72, 24), (64, 40, 512), (49, 33, 3072)])
def test_three_products_hold_float32_class_error(M, N, K):
    x, w, b = operands(M, N, K, seed=K)
    assert scaled_error(F.linear(x, w, b), x, w, b) < TOL  # the yardstick itself
    got = L.linear_tf32x3_reference(x, w, b)
    assert scaled_error(got, x, w, b) < TOL
    xb, wb = L.split_tf32(x)[0], L.split_tf32(w)[0]
    assert scaled_error(F.linear(xb, wb, b), x, w, b) > 10 * TOL  # one TF32 pass
    g = L.linear_tf32x3_reference(x, w, b, gelu=True)
    assert scaled_error(g, x, w, b, gelu=True) < TOL


@pytest.mark.parametrize("gelu", [False, True])
def test_cpu_path_is_f_linear_bit_for_bit(gelu):
    x, w, b = operands(2 * 49, 40, 24, seed=1)
    x = x.reshape(2, 49, 24)
    want = F.linear(x, w, b)
    want = F.gelu(want) if gelu else want
    assert torch.equal(L.linear_tf32x3(x, w, b, gelu), want)
    assert torch.equal(L.linear_tf32x3(x, L.split_tf32(w), b, gelu), want)
    before = L.linear_tf32x3.launches
    lin = torch.nn.Linear(24, 40)
    with torch.no_grad():
        lin.weight.copy_(w)
        lin.bias.copy_(b)
    assert torch.equal(L.FusedLinear(lin)(x, gelu), want)
    assert L.linear_tf32x3.launches == before


def test_operands_pad_k_to_a_multiple_of_4():
    w = torch.randn(8, 6)
    big, small = L._operands(w)
    assert big.shape == (8, 8) and torch.equal((big + small)[:, :6], w)
    assert not big[:, 6:].any() and not small[:, 6:].any()


def _tiny_model(seed=0):
    cfg = W.Wav2Vec2Config.tiny()
    sd = W.random_state_dict(cfg, seed)
    return W.build_model(cfg, sd, "cpu"), cfg


def test_cached_operands_follow_the_parameters():
    model, cfg = _tiny_model()
    att = model.encoder.layers[0].attention
    (big, small), bias = att.qkv.operands()
    w = torch.cat([att.q_proj.weight, att.k_proj.weight, att.v_proj.weight])
    assert torch.equal(big + small, w)
    assert att.qkv.operands()[0][0] is big  # cached while nothing changes

    # load_state_dict copies in place: the version moves
    sd = W.random_state_dict(cfg, seed=1)
    model.load_state_dict(sd)
    (big, small), bias = att.qkv.operands()
    assert torch.equal(big + small, torch.cat([sd[f"encoder.layers.0.attention.{p}_proj.weight"]
                                               for p in "qkv"]))
    assert torch.equal(bias, torch.cat([sd[f"encoder.layers.0.attention.{p}_proj.bias"]
                                        for p in "qkv"]))
    # an in-place change of one parameter
    with torch.no_grad():
        att.v_proj.bias.add_(1.0)
    assert torch.equal(att.qkv.operands()[1][2 * cfg.hidden_size:], att.v_proj.bias)
    # new parameter tensors (load_state_dict(assign=True))
    ff = model.encoder.layers[1].feed_forward
    new = {k: v + 1.0 for k, v in model.state_dict().items()}
    model.load_state_dict(new, assign=True)
    (big, small), _ = ff.intermediate.operands()
    assert torch.equal(big + small, ff.intermediate_dense.weight)
    # parameters made under inference mode carry no version counter
    with torch.inference_mode():
        loaded, _ = _tiny_model(seed=2)
    (big, small), _ = loaded.encoder.layers[0].attention.out.operands()
    assert torch.equal(big + small, loaded.encoder.layers[0].attention.out_proj.weight)


def test_state_dict_names_are_unchanged():
    model, cfg = _tiny_model()
    names = set(model.state_dict())
    assert names == set(W.random_state_dict(cfg, 0))
    linears = [n for n in names if n.endswith(("proj.weight", "dense.weight", "projection.weight"))]
    assert len(linears) == 6 * cfg.num_layers + 1  # q, k, v, out, two FFN; the projection
    assert not any(part in ("qkv", "out", "intermediate", "output", "fused")
                   for n in names for part in n.split("."))


def test_fused_qkv_gives_the_three_projections():
    model, cfg = _tiny_model(seed=3)
    att = model.encoder.layers[1].attention
    u = torch.randn(2, 49, cfg.hidden_size, generator=torch.Generator().manual_seed(4))
    q, k, v = att.qkv(u)
    for got, lin in zip((q, k, v), (att.q_proj, att.k_proj, att.v_proj)):
        assert torch.equal(got, lin(u))
    # the concatenated operands, as the card gets them
    pair, bias = att.qkv.operands()
    fused = L.linear_tf32x3_reference(u, pair[0] + pair[1], bias)
    D = cfg.hidden_size
    for i, lin in enumerate((att.q_proj, att.k_proj, att.v_proj)):
        want = L.linear_tf32x3_reference(u, lin.weight, lin.bias)
        torch.testing.assert_close(fused[..., i * D:(i + 1) * D], want, rtol=0, atol=1e-6)


# -- the card -------------------------------------------------------------------------

# (K, N) of every linear of wav2vec2-base and of WavLM-Large: projection, Q/K/V,
# out_proj, intermediate_dense, output_dense
SHAPES = [(512, 768), (768, 2304), (768, 768), (768, 3072), (3072, 768),
          (512, 1024), (1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [12544, 1568, 1571])
@pytest.mark.parametrize("K, N", SHAPES)
def test_kernel_against_float64_on_card(cuda_device, M, K, N):
    x, w, b = operands(M, N, K, seed=M + K + N, device=cuda_device)
    before = L.linear_tf32x3.launches
    for gelu in (False, True):
        got = L.linear_tf32x3(x, w, b, gelu)
        torch.cuda.synchronize()
        assert scaled_error(got, x, w, b, gelu) < TOL
    assert L.linear_tf32x3.launches == before + 2
    xb, wb = L.split_tf32(x)[0], L.split_tf32(w)[0]
    assert scaled_error(F.linear(xb, wb, b), x, w, b) > TOL  # one TF32 pass


def hf_config(cfg: W.Wav2Vec2Config) -> dict:
    """The port's config under HF's keys, as the plain reference reads them."""
    keys = {"conv_dim": "conv_dim", "conv_kernel": "conv_kernel", "conv_stride": "conv_stride",
            "conv_bias": "conv_bias", "feat_extract_norm": "feat_extract_norm",
            "do_stable_layer_norm": "do_stable_layer_norm", "hidden_size": "hidden_size",
            "num_hidden_layers": "num_layers", "num_attention_heads": "num_heads",
            "intermediate_size": "ffn_dim", "num_conv_pos_embeddings": "pos_conv_kernel",
            "num_conv_pos_embedding_groups": "pos_conv_groups", "layer_norm_eps": "layer_norm_eps",
            "num_buckets": "num_buckets", "max_bucket_distance": "max_bucket_distance",
            "do_normalize": "do_normalize"}
    return {hf: getattr(cfg, ours) for hf, ours in keys.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["tiny", "base", "wavlm_large"])
def test_encoder_on_card_against_plain_reference(cuda_device, which):
    # the plain reference's group norm is per channel, as in HF's wav2vec2
    tiny = dataclasses.replace(W.Wav2Vec2Config.tiny(), num_groupnorm_groups=16)
    cfg = {"tiny": tiny, "base": W.Wav2Vec2Config.base(),
           "wavlm_large": W.Wav2Vec2Config.wavlm_large()}[which]
    g = torch.Generator().manual_seed(7)
    sd = W.random_state_dict(cfg, seed=7)
    for name in sd:  # biases of the linears not zero, so the epilogue's add shows
        if name.endswith(("proj.bias", "dense.bias", "projection.bias")):
            sd[name] = 0.1 * torch.randn(sd[name].shape, generator=g)
        elif name.endswith("rel_attn_embed.weight"):
            sd[name] = torch.randn(sd[name].shape, generator=g)
    model = W.build_model(cfg, sd, cuda_device)
    audio = torch.randn(6, 16000, generator=g).to(cuda_device)
    lengths = torch.tensor([16000, 16000, 12000, 16000, 8000, 16000], device=cuda_device)
    before = L.linear_tf32x3.launches
    with torch.inference_mode(), plain_wavlm.no_tf32():  # the convs too, as core/torch_setup
        got = model(audio, lengths)
    torch.cuda.synchronize()
    assert L.linear_tf32x3.launches - before == 4 * cfg.num_layers + 1
    sd_dev = {k: v.to(cuda_device) for k, v in sd.items()}
    with torch.no_grad():
        want = plain_wavlm.frames(sd_dev, hf_config(cfg), audio, lengths)
    t_valid = W.feature_extractor_output_length(cfg, lengths)
    for row in range(audio.shape[0]):
        n = int(t_valid[row])
        a, b = got[row, :n].double(), want[row, :n].double()
        gap = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
        assert gap < 2e-5, (which, row, gap)  # one TF32 pass: some 1e-3
