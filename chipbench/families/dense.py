"""The dense GQA decoder (granite-3-8b): the embedding, then
``num_layers`` pre-norm blocks of GQA attention and a SwiGLU MLP."""

from chipbench import costs
from chipbench.reference import model, params


def leaves(port: dict) -> dict:
    return {**params.embedding(port),
            **params.stack(params.attn_block(port), "dense_layers",
                           port["num_layers"])}


def hidden(p: dict, port: dict, tokens, mm):
    x = p["embed/embedding"][tokens].float()
    for i in range(port["num_layers"]):
        x = model.attn_block(model.layer_params(p, "dense_layers", i), x,
                             port, mm)
    return x


def flop_params(port: dict) -> int:
    return port["num_layers"] * costs.attn_block_params(port) \
        + costs.head_params(port)
