"""Forward pass of the configurations the benchmark runs, in plain PyTorch.

The pieces every family shares, as the port computes them
(``repro_torch.models``), written from their equations with no kernel,
cache or batching: RMSNorm, GQA attention with RoPE (split halves) and a
causal softmax, SwiGLU, the pre-norm attention block, and the logits over
the published vocabulary through the tied embedding or the output head
after the final RMSNorm.  Each family's module (``families/<family>.py``)
gives the blocks between the embedding and the final norm.

Departures from the published models are the port's and are listed in
each configuration file (``departures``); the reference follows the port.
Everything is fp32.  The padded vocabulary rows, masked to -1e9 by the
port, are left out of the logits, which is the same softmax.  Every
product goes through a :class:`Products` object: fp32 with TF32 off, or,
for the control, operands rounded to fp8 (e4m3, one scale a tensor).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chipbench import common


def no_tf32() -> None:
    """fp32 products in fp32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Products:
    """``mm(a, b)``: a @ b in fp32, or with ``fp8`` each operand first
    rounded to float8 e4m3 under one scale a tensor (its largest magnitude
    to 448), its gradient passed straight through: the precision a step
    below the configuration's bf16."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    @staticmethod
    def _round(t: torch.Tensor) -> torch.Tensor:
        scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (q - t).detach()

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = self._round(a), self._round(b)
        return a @ b


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta: float):
    """x: (B, S, H, D) at positions 0 .. S - 1, split-halves rotation."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device), exps)
    ang = torch.arange(s, device=x.device).float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: dict, x, port: dict, mm: Products):
    """Causal GQA self-attention; p holds wq, wk, wv, wo."""
    b, s, d = x.shape
    h, kv, hd = port["num_heads"], port["num_kv_heads"], port["head_dim"]
    q = mm(x, p["wq"].reshape(d, h * hd)).view(b, s, h, hd)
    k = mm(x, p["wk"].reshape(d, kv * hd)).view(b, s, kv, hd)
    v = mm(x, p["wv"].reshape(d, kv * hd)).view(b, s, kv, hd)
    q, k = rope(q, port["rope_theta"]), rope(k, port["rope_theta"])
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = mm(probs, v.transpose(1, 2)).transpose(1, 2).reshape(b, s, h * hd)
    return mm(out, p["wo"].reshape(h * hd, d))


def swiglu(p: dict, x, mm: Products):
    return mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]), p["w_down"])


def attn_block(p: dict, x, port: dict, mm: Products):
    """Pre-norm block; p keys as ``params.leaves`` names them, unstacked."""
    eps = port["norm_eps"]
    x = x + attention({k[5:]: v for k, v in p.items()
                       if k.startswith("attn/")},
                      rmsnorm(x, p["ln1/scale"], eps), port, mm)
    return x + swiglu({k[4:]: v for k, v in p.items()
                       if k.startswith("mlp/")},
                      rmsnorm(x, p["ln2/scale"], eps), mm)


def layer_params(params: dict, prefix: str, *index: int) -> dict:
    """The leaves of one layer of a stack in fp32 (served bf16 weights are
    upcast a layer at a time), keys without the prefix."""
    out = {}
    for k, v in params.items():
        if k.startswith(prefix + "/"):
            for i in index:
                v = v[i]
            out[k[len(prefix) + 1:]] = v.float()
    return out


def logits(params: dict, port: dict, tokens, mm: Products,
           vocab: int | None = None):
    """(B, S, vocab) logits, over the published vocabulary by default;
    serving reads them over every row of the padded head, as the port's
    greedy argmax does."""
    x = common.family(port).hidden(params, port, tokens, mm)
    x = rmsnorm(x, params["final_norm/scale"].float(), port["norm_eps"])
    v = vocab or port["vocab_size"]
    head = params["embed/embedding"][:v].float().T \
        if port["tie_embeddings"] else params["embed/lm_head"][:, :v].float()
    return mm(x, head)
