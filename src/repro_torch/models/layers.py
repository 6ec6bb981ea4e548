"""Shared layers: norms, RoPE, MLPs, embeddings (port of
``repro.models.layers``).

Plain functions on tensors; parameters are nested dicts keyed like the JAX
tree.  RoPE tables come from integer positions (:func:`rope_table`) or,
for Qwen2-VL's M-RoPE, from (t, h, w) positions (:func:`mrope_table`).  The compute dtype follows the activations; parameters are cast at use
sites as in the reference (a no-op when the bridge already cast them once).
Every RMSNorm goes through the fused kernel wrapper
(:func:`repro_torch.kernels.ops.fused_rmsnorm`); layernorm stays plain.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import spec
from repro_torch.parallel import comm

# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def norm_specs(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": spec((d,), ("norm",), init="ones"),
                "bias": spec((d,), ("norm",), init="zeros")}
    return {"scale": spec((d,), ("norm",), init="ones")}


def apply_norm(p, x, cfg: ModelConfig, eps: Optional[float] = None):
    eps = eps or cfg.norm_eps
    if cfg.norm_type != "layernorm":
        return ops.fused_rmsnorm(x, p["scale"], eps=eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rmsnorm_gated(scale, x, gate, eps: float = 1e-5, tp=None,
                  width: Optional[int] = None):
    """Mamba2-style gated RMSNorm: norm(x * silu(gate)) * scale.

    The gate product is taken in x's dtype, as the reference does; the norm
    is the fused RMSNorm with the fp32 ``scale``.  ``tp`` (a
    :class:`~repro_torch.parallel.sharding.TensorParallel` layout) with
    ``width`` above x's last dimension: x holds this rank's columns of rows
    of ``width`` (its heads' of d_inner), normalised by the whole row's
    mean square, summed over "model" (``ops.fused_rmsnorm_split``)."""
    x = x * F.silu(gate.float()).to(x.dtype)
    if tp is not None and width is not None and width != x.shape[-1]:
        return ops.fused_rmsnorm_split(x, scale, width=width, mesh=tp.mesh,
                                       eps=eps)
    return ops.fused_rmsnorm(x, scale, eps=eps)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., S) int -> cos, sin: (..., S, head_dim // 2) fp32."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_table(positions: torch.Tensor, head_dim: int, theta: float,
                sections):
    """Qwen2-VL multimodal RoPE: positions (..., S, 3) int for (t, h, w).

    The head_dim // 2 frequency bands are split into ``sections`` (t, h,
    w, in that order); each band takes its angle from its component.
    Returns cos, sin of shape (..., S, head_dim // 2), fp32."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {half}")
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    comp = torch.cat([torch.full((s,), i, dtype=torch.long)
                      for i, s in enumerate(sections)]).to(positions.device)
    ang = positions.float()[..., comp] * freqs              # (..., S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos).

    x: (..., S, H, D); cos/sin: (..., S, half), broadcast over heads.
    Split-halves convention (llama).  The tables are cast to x's dtype
    before the multiply, as the reference does.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": spec((d, ff), ("embed", "mlp")),
            "w_up": spec((d, ff), ("embed", "mlp")),
            "w_down": spec((ff, d), ("mlp", "embed")),
        }
    return {
        "w_up": spec((d, ff), ("embed", "mlp")),
        "w_down": spec((ff, d), ("mlp", "embed")),
    }


def apply_mlp(p, x, cfg: ModelConfig):
    dt = x.dtype
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    elif cfg.mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_up"].to(dt), approximate="tanh")
    elif cfg.mlp_type == "relu2":
        h = torch.relu(x @ p["w_up"].to(dt)).square()
    else:
        raise ValueError(cfg.mlp_type)
    return h @ p["w_down"].to(dt)


# --------------------------------------------------------------------------
# Embedding / LM head
# --------------------------------------------------------------------------


def embedding_specs(cfg: ModelConfig):
    v, d = cfg.vocab_padded, cfg.d_model
    out = {"embedding": spec((v, d), ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        out["lm_head"] = spec((d, v), ("embed", "vocab"))
    return out


def embed_tokens(p, tokens, cfg: ModelConfig, tp=None):
    """(B, S) tokens -> (B, S, d) in the compute dtype.  ``tp`` (a
    :class:`~repro_torch.parallel.sharding.TensorParallel` layout): the
    rows in this pass's layout; where the embedding is this rank's piece
    of the vocabulary, tokens outside its range read zero and the ranks'
    rows are summed over "model"."""
    dt = getattr(torch, cfg.dtype)
    table = p["embedding"]
    if tp is None:
        # gather then cast: the same values as the reference's
        # cast-then-gather
        return table[tokens].to(dt)
    if table.shape[0] == cfg.vocab_padded:
        return tp.local(table[tokens].to(dt))
    n = table.shape[0]
    local = tokens - tp.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)
    return tp.reduce(rows.to(dt))


def lm_logits(p, h, cfg: ModelConfig, tp=None):
    """(B, S, vocab_padded) logits; with ``tp`` and the vocabulary split
    over "model", this rank's (B, S, vocab_padded / tp) columns of them,
    from the whole sequence."""
    if cfg.tie_embeddings:
        w = p["embedding"].to(h.dtype).T
    else:
        w = p["lm_head"].to(h.dtype)
    if tp is not None:
        h = tp.enter(h, w.shape[-1] != cfg.vocab_padded)
    return h @ w


def cross_entropy(logits, targets, cfg: ModelConfig, mask=None,
                  denominator=None, tp=None):
    """Mean CE over valid targets, in fp32; padded vocab entries are set
    to -1e9.  logits: (B, S, vocab_padded); targets: (B, S) int; mask:
    (B, S) or None (then every target counts).  ``denominator`` (with a
    mask): divide the masked sum by it in place of the valid count (the
    data-parallel loss's global count).

    ``tp`` with logits of this rank's columns of the vocabulary
    (:func:`lm_logits`): vocabulary-parallel.  The padded entries are
    masked in the shard that holds them; the row maximum (detached), the
    sum of exponentials and the gold logit (read by the rank that holds the
    target) are each reduced over "model", so every rank computes the
    same loss."""
    lf = logits.float()
    n = lf.shape[-1]
    v0 = 0 if tp is None or n == cfg.vocab_padded else tp.rank * n
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(v0, v0 + n, device=lf.device) >= cfg.vocab_size
        lf = lf.masked_fill(pad, -1e9)
    if n == cfg.vocab_padded:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    else:
        m = comm.all_reduce(lf.detach().amax(dim=-1), tp.mesh, ("model",),
                            "max")
        lse = torch.log(comm.reduce_from_model(
            torch.exp(lf - m[..., None]).sum(dim=-1), tp.mesh)) + m
        local = targets.long() - v0
        inside = (local >= 0) & (local < n)
        gold = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = comm.reduce_from_model(
            torch.where(inside, gold, torch.zeros_like(gold)), tp.mesh)
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    if denominator is not None:
        return (nll * mask).sum() / denominator
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
