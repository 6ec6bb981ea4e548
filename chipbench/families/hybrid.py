"""The Mamba2 hybrid with shared attention blocks (zamba2): groups of
``attn_every`` pre-norm Mamba2 layers, each group followed by a shared
attention block (weight set ``group % num_shared_blocks``), then the
remaining Mamba2 layers.

The Mamba2 mixer: in_proj -> [z, x, B, C, dt], a depthwise causal conv of
width 4 and SiLU over [x, B, C], dt = softplus(dt + dt_bias), A =
-exp(A_log), the SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t
B_t^T, y_t = h_t C_t (here in its chunked quadratic form, exact in fp32),
y + D x, a gated RMSNorm (norm(y * silu(z))), out_proj.
"""

import torch
import torch.nn.functional as F

from chipbench import costs
from chipbench.reference import model, params
from chipbench.reference.params import Leaf


def _widths(port: dict) -> tuple:
    """(d_inner, heads, B/C width, conv channels) of a Mamba2 layer."""
    s = port["ssm"]
    di = s["expand"] * port["d_model"]
    gn = s["n_groups"] * s["state_dim"]
    return di, di // s["head_dim"], gn, di + 2 * gn


def mamba_block(port: dict) -> dict:
    d = port["d_model"]
    di, nh, gn, conv = _widths(port)
    return {"ln/scale": Leaf((d,), init="ones"),
            "in_proj": Leaf((d, 2 * di + 2 * gn + nh)),
            "conv_w": Leaf((port["ssm"]["conv_width"], conv), scale=0.5),
            "conv_b": Leaf((conv,), init="zeros"),
            "dt_bias": Leaf((nh,), init="zeros"),
            "A_log": Leaf((nh,), init="constant", value=0.0),
            "D": Leaf((nh,), init="ones"),
            "norm_scale": Leaf((di,), init="ones"),
            "out_proj": Leaf((di, d))}


def leaves(port: dict) -> dict:
    every = port["hybrid"]["attn_every"]
    groups, rem = divmod(port["num_layers"], every)
    out = params.embedding(port)
    if groups:
        out.update(params.stack(mamba_block(port), "groups", groups, every))
    if rem:
        out.update(params.stack(mamba_block(port), "rem", rem))
    out.update(params.stack(params.attn_block(port), "shared",
                            port["hybrid"]["num_shared_blocks"]))
    return out


def flop_params(port: dict) -> int:
    """Every Mamba2 layer, and a shared block once per application."""
    d = port["d_model"]
    di, nh, gn, conv = _widths(port)
    mamba = (d * (2 * di + 2 * gn + nh) + port["ssm"]["conv_width"] * conv
             + conv + 3 * nh + di + di * d + d)
    applications = port["num_layers"] // port["hybrid"]["attn_every"]
    return port["num_layers"] * mamba \
        + applications * costs.attn_block_params(port) \
        + costs.head_params(port)


def ssd(x, a, bm, cm, chunk: int, init_state=None):
    """The SSD recurrence in chunked form, fp32.

    x: (B, L, H, P), already times dt; a: (B, L, H) log decays (<= 0);
    bm, cm: (B, L, G, N), head h reading group h // (H / G); init_state
    (B, H, P, N) or None.  Returns (y (B, L, H, P), final state)."""
    bsz, l, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    bm = bm.repeat_interleave(h // g, dim=2)
    cm = cm.repeat_interleave(h // g, dim=2)
    state = x.new_zeros(bsz, h, p, n) if init_state is None else init_state
    ys = []
    tri = None
    for c0 in range(0, l, chunk):
        xs, a_s = x[:, c0:c0 + chunk], a[:, c0:c0 + chunk]
        bs, cs = bm[:, c0:c0 + chunk], cm[:, c0:c0 + chunk]
        q = xs.shape[1]
        cum = torch.cumsum(a_s, dim=1)                       # (B, Q, H)
        if tri is None or tri.shape[0] != q:
            tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        # decay from step s to step t (s <= t): exp(cum_t - cum_s)
        diff = cum.transpose(1, 2)[:, :, :, None] \
            - cum.transpose(1, 2)[:, :, None, :]             # (B, H, Q, Q)
        decay = torch.exp(diff.masked_fill(~tri, float("-inf")))
        cb = torch.einsum("bthn,bshn->bhts", cs, bs)
        y = torch.einsum("bhts,bshp->bthp", cb * decay, xs)
        # the state carried in, decayed to each step, read by C
        y = y + torch.einsum("bthn,bhpn->bthp", cs, state) \
            * torch.exp(cum)[..., None]
        ys.append(y)
        to_end = torch.exp(cum[:, -1:] - cum)                # (B, Q, H)
        state = state * torch.exp(cum[:, -1])[..., None, None] \
            + torch.einsum("bshn,bshp->bhpn", bs * to_end[..., None], xs)
    return torch.cat(ys, dim=1), state


def mamba2(p: dict, x, port: dict, mm):
    """The Mamba2 mixer over a whole sequence from a zero state."""
    s = port["ssm"]
    bsz, l, d = x.shape
    di = s["expand"] * d
    nh, hp = di // s["head_dim"], s["head_dim"]
    g, n = s["n_groups"], s["state_dim"]
    zx = mm(x, p["in_proj"])
    z, xbc, dt = zx[..., :di], zx[..., di:2 * di + 2 * g * n], zx[..., -nh:]
    w = p["conv_w"]
    width = w.shape[0]
    ext = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(ext[:, i:i + l] * w[i] for i in range(width))
    xbc = F.silu(conv + p["conv_b"])
    xin = xbc[..., :di].reshape(bsz, l, nh, hp)
    bm = xbc[..., di:di + g * n].reshape(bsz, l, g, n)
    cm = xbc[..., di + g * n:].reshape(bsz, l, g, n)
    dt = F.softplus(dt + p["dt_bias"])
    a = dt * -torch.exp(p["A_log"])
    y, _ = ssd(xin * dt[..., None], a, bm, cm, s["chunk_size"])
    y = (y + xin * p["D"][:, None]).reshape(bsz, l, di)
    y = model.rmsnorm(y * F.silu(z), p["norm_scale"], port["norm_eps"])
    return mm(y, p["out_proj"])


def hidden(p: dict, port: dict, tokens, mm):
    x = p["embed/embedding"][tokens].float()
    every = port["hybrid"]["attn_every"]
    nsb = port["hybrid"]["num_shared_blocks"]
    groups, rem = divmod(port["num_layers"], every)
    eps = port["norm_eps"]

    def mamba_layer(lp, x):
        return x + mamba2(lp, model.rmsnorm(x, lp["ln/scale"], eps), port,
                          mm)

    for gi in range(groups):
        for li in range(every):
            x = mamba_layer(model.layer_params(p, "groups", gi, li), x)
        x = model.attn_block(model.layer_params(p, "shared", gi % nsb), x,
                             port, mm)
    for li in range(rem):
        x = mamba_layer(model.layer_params(p, "rem", li), x)
    return x
