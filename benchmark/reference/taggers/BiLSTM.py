"""The BiLSTM tagger: a stack of bidirectional LSTM layers over each
document's own length and a linear head. Gates i, f, g, o; c' = f c + i g;
h' = o tanh(c'). JAX layout: rnn[layer][fwd|bwd] = {w_ih [in, 4H], w_hh
[H, 4H], b_ih, b_hh}, cls = {w [2H, 1], b}."""
from __future__ import annotations

import torch

from ..models import dense_leaves, linear_init, reverse_in_length


def leaves(tc: dict):
    H, d = tc["hidden_dim"], tc["embedding_dim"]
    out = []
    for layer in range(tc["num_layers"]):
        for direction in ("fwd", "bwd"):
            base = f"rnn/{layer}/{direction}"
            out += [(f"{base}/w_ih", (d, 4 * H), d ** -0.5, 0.0),
                    (f"{base}/w_hh", (H, 4 * H), H ** -0.5, 0.0),
                    (f"{base}/b_ih", (4 * H,), 0.1, 0.0),
                    (f"{base}/b_hh", (4 * H,), 0.1, 0.0)]
        d = 2 * H
    return out + dense_leaves("cls", d, 1)


def initial_params(tc: dict, seed: int) -> dict:
    """The reference trainer's TF-style init, drawn in the order the modules
    are built from one CPU generator: Xavier-uniform input weights,
    orthogonal recurrent weights, zero biases with the forget gate's input
    bias at 1; the head U(+-1/sqrt(fan_in))."""
    g = torch.Generator().manual_seed(seed)
    H, d = tc["hidden_dim"], tc["embedding_dim"]
    layers = []
    for _ in range(tc["num_layers"]):
        pair = {}
        for direction in ("fwd", "bwd"):
            w_ih = torch.nn.init.xavier_uniform_(torch.empty(4 * H, d), generator=g)
            w_hh = torch.nn.init.orthogonal_(torch.empty(4 * H, H), generator=g)
            b_ih = torch.zeros(4 * H)
            b_ih[H:2 * H] = 1.0
            pair[direction] = {"w_ih": w_ih.T.contiguous(), "w_hh": w_hh.T.contiguous(),
                               "b_ih": b_ih, "b_hh": torch.zeros(4 * H)}
        layers.append(pair)
        d = 2 * H
    return {"rnn": layers, "cls": linear_init(g, d, 1)}


def lstm_layer(x, lengths, fwd: dict, bwd: dict) -> torch.Tensor:
    """One bidirectional layer over padded rows: x [B, L, d] -> [B, L, 2H],
    zero past each row's length. The backward direction starts at each row's
    last valid step."""
    H = fwd["w_hh"].shape[0]
    xs = torch.stack([x, reverse_in_length(x, lengths)])  # [2, B, L, d]
    w_ih = torch.stack([fwd["w_ih"], bwd["w_ih"]])
    w_hh = torch.stack([fwd["w_hh"], bwd["w_hh"]])
    bias = torch.stack([fwd["b_ih"] + fwd["b_hh"], bwd["b_ih"] + bwd["b_hh"]])
    gx = torch.einsum("zbld,zdg->zblg", xs, w_ih) + bias[:, None, None, :]
    B, L = x.shape[:2]
    h = x.new_zeros(2, B, H)
    c = x.new_zeros(2, B, H)
    outs = []
    for t in range(L):
        g = gx[:, :, t] + torch.bmm(h, w_hh)
        i, f, gg, o = g.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    out = torch.stack(outs, dim=2)  # [2, B, L, H]
    y = torch.cat([out[0], reverse_in_length(out[1], lengths)], dim=-1)
    mask = torch.arange(L, device=x.device)[None, :] < torch.as_tensor(lengths, device=x.device)[:, None]
    return y * mask[..., None].to(y.dtype)


def logits(params: dict, x: torch.Tensor, lengths, tc: dict = None) -> torch.Tensor:
    """x [B, L, d] -> logits [B, L], over the longest row's length only."""
    lengths = [int(n) for n in lengths]
    h = x[:, :max(lengths)]
    for layer in params["rnn"]:
        h = lstm_layer(h, lengths, layer["fwd"], layer["bwd"])
    return (h @ params["cls"]["w"] + params["cls"]["b"])[..., 0]
