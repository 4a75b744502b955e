"""Transformer language model, serving half: prefill and slab decode.

Port of ``veles_tpu/models/transformer.py``. Same configuration, the
same numpy-seeded weights (:func:`init_params` draws in the same
order, so both packages start from bit-identical parameters), the
same pre-LN blocks with learned positions and a tied embedding/LM
head, and the same dtype policy: f32 master params, activations in the
compute dtype, f32 layer-norm statistics and f32 logits. Weights keep
the reference's ``[in, out]`` layout, so ``x @ W`` is ``jnp.dot(x,
W)``; ``.to(compute dtype)`` sits where the reference has
``.astype(cd)``.

Parameters are a plain dict of tensors (:func:`params_from_numpy`
builds it from the JAX package's tree as numpy arrays). Attention runs
through ``ops.flash_attention``: the K1 forward kernel in
:func:`prefill` and :func:`forward`, the K4 decode kernel in
:func:`decode_step`, on CUDA tensors; their plain PyTorch versions on
CPU tensors.

Not ported here: the training half (loss, Adam, ``TransformerTrainer``)
and the mixture-of-experts FFN, both queued in ROADMAP.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from veles_tpu_torch.device import compute_dtype as _compute_dtype
from veles_tpu_torch.device import resolve
from veles_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_decode)


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    embed: int = 128
    heads: int = 4
    layers: int = 2
    seq_len: int = 128
    mlp_ratio: int = 4
    #: >0 turns the FFN into a top-1-routed mixture of experts (not
    #: ported yet: :func:`_ffn` raises).
    moe_experts: int = 0
    moe_aux_weight: float = 1e-2
    #: "float32" | "bfloat16": the activation dtype (f32 master
    #: params, f32 layer-norm stats and logits either way).
    compute: str = "float32"
    #: "flash" is the only attention of the port; the reference's
    #: "dense" oracle is a debugging path left unported.
    attention: str = "flash"
    #: Force the flash implementation: "plain" | "cuda" | None (auto:
    #: the kernels on CUDA tensors, the plain path on CPU tensors).
    attention_impl: Optional[str] = None
    #: Tiles of the plain flash path; None = ops.flash_attention
    #: defaults. The kernels tile on their own.
    block_q: Optional[int] = None
    block_k: Optional[int] = None
    #: Training-half knobs, kept so a configuration reads the same in
    #: both packages; the serving path does not read them.
    scan_layers: bool = True
    remat: str = "attn"
    ce_chunk: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.embed // self.heads

    def compute_dtype(self) -> torch.dtype:
        return _compute_dtype(self.compute)


def init_params(config: TransformerConfig, seed: int = 0) -> Dict[str, Any]:
    """numpy f32 parameter tree, drawn exactly as the JAX package
    draws it (same generator, same order)."""
    rng = np.random.default_rng(seed)

    def dense(fan_in, shape):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    params: Dict[str, Any] = {
        "embed": (rng.standard_normal((config.vocab, config.embed))
                  * 0.02).astype(np.float32),
        "pos": (rng.standard_normal((config.seq_len, config.embed))
                * 0.02).astype(np.float32),
        "ln_f": {"g": np.ones(config.embed, np.float32),
                 "b": np.zeros(config.embed, np.float32)},
        "blocks": [],
    }
    e, m = config.embed, config.embed * config.mlp_ratio
    for _ in range(config.layers):
        block = {
            "ln1": {"g": np.ones(e, np.float32),
                    "b": np.zeros(e, np.float32)},
            "qkv": dense(e, (e, 3 * e)),
            "proj": dense(e, (e, e)),
            "ln2": {"g": np.ones(e, np.float32),
                    "b": np.zeros(e, np.float32)},
        }
        if config.moe_experts > 0:
            n_exp = config.moe_experts
            block["gate"] = dense(e, (e, n_exp))
            block["mlp_in"] = dense(e, (n_exp, e, m))
            block["mlp_out"] = dense(m, (n_exp, m, e))
        else:
            block["mlp_in"] = dense(e, (e, m))
            block["mlp_out"] = dense(m, (m, e))
        params["blocks"].append(block)
    return params


def _expected_shapes(config: TransformerConfig) -> Dict[str, Any]:
    e, m = config.embed, config.embed * config.mlp_ratio
    ln = {"g": (e,), "b": (e,)}
    block = {"ln1": ln, "qkv": (e, 3 * e), "proj": (e, e), "ln2": ln}
    if config.moe_experts > 0:
        n_exp = config.moe_experts
        block.update(gate=(e, n_exp), mlp_in=(n_exp, e, m),
                     mlp_out=(n_exp, m, e))
    else:
        block.update(mlp_in=(e, m), mlp_out=(m, e))
    return {"embed": (config.vocab, e), "pos": (config.seq_len, e),
            "ln_f": ln, "blocks": [block] * config.layers}


def params_from_numpy(tree, config: TransformerConfig,
                      device) -> Dict[str, Any]:
    """The JAX package's parameter tree (``init_params`` output, or
    ``jax.tree.map(np.asarray, trainer.params)``) -> the port's tree of
    f32 tensors on ``device``, same structure, same ``[in, out]``
    layouts. Tensor leaves are moved as they are. Raises
    ``ValueError`` when the tree does not fit ``config``."""
    device = torch.device(device)

    def convert(node, shape, path):
        if isinstance(shape, dict):
            if not isinstance(node, dict) or set(node) != set(shape):
                raise ValueError("params_from_numpy: %s has keys %s, "
                                 "config wants %s" % (
                                     path or "<root>",
                                     sorted(node) if isinstance(
                                         node, dict) else type(node),
                                     sorted(shape)))
            return {key: convert(node[key], shape[key],
                                 "%s/%s" % (path, key))
                    for key in shape}
        if isinstance(shape, list):
            if len(node) != len(shape):
                raise ValueError("params_from_numpy: %s has %d blocks, "
                                 "config wants %d"
                                 % (path, len(node), len(shape)))
            return [convert(n, s, "%s/%d" % (path, i))
                    for i, (n, s) in enumerate(zip(node, shape))]
        if isinstance(node, torch.Tensor):
            leaf = node.detach().to(device=device, dtype=torch.float32)
        else:
            leaf = torch.from_numpy(
                np.ascontiguousarray(node, dtype=np.float32)).to(device)
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError("params_from_numpy: %s has shape %s, config "
                             "wants %s" % (path, tuple(leaf.shape), shape))
        return leaf

    return convert(tree, _expected_shapes(config), "")


def _layer_norm(x, g, b):
    xf = x.float()  # stats in f32 regardless of policy
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) / torch.sqrt(var + 1e-5) * g + b).to(x.dtype)


def _qkv(x, block, config: TransformerConfig):
    """x [B,T,E] -> (q, k, v) each [B,T,H,Dh]: strided views into one
    fused projection (the kernels read them in place)."""
    b, t, _ = x.shape
    cd = config.compute_dtype()
    qkv = x @ block["qkv"].to(cd)                         # [B,T,3E]
    qkv = qkv.view(b, t, 3, config.heads, config.head_dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _ffn(h, block, config: TransformerConfig):
    """The dense gelu MLP branch; returns the residual delta.
    ``jax.nn.gelu`` defaults to the tanh approximation, so does this."""
    if config.moe_experts > 0:
        raise NotImplementedError(
            "the mixture-of-experts FFN is not ported yet (ROADMAP.md "
            "queue 1: MoE decode)")
    cd = config.compute_dtype()
    h = F.gelu(h @ block["mlp_in"].to(cd), approximate="tanh")
    return h @ block["mlp_out"].to(cd)


def _attention_forward(x, block, config: TransformerConfig):
    """Pre-LN causal attention branch; returns (delta, k, v)."""
    if config.attention != "flash":
        raise ValueError("the port's TransformerConfig.attention is "
                         "'flash', got %r" % (config.attention,))
    b, t, e = x.shape
    cd = config.compute_dtype()
    h = _layer_norm(x, block["ln1"]["g"], block["ln1"]["b"])
    q, k, v = _qkv(h, block, config)
    out = flash_attention(q, k, v, causal=True, block_q=config.block_q,
                          block_k=config.block_k,
                          impl=config.attention_impl)
    return out.reshape(b, t, e) @ block["proj"].to(cd), k, v


def _block_forward_kv(x, block, config: TransformerConfig):
    """One pre-LN block that also returns its (k, v): the prefill
    body, the same ops in the same order as the full forward."""
    delta, k, v = _attention_forward(x, block, config)
    x = x + delta
    h = _layer_norm(x, block["ln2"]["g"], block["ln2"]["b"])
    return x + _ffn(h, block, config), (k, v)


def _embed(params, tokens, positions, cd):
    return (params["embed"][tokens] + params["pos"][positions]).to(cd)


def _lm_head(x, params, cd):
    """f32 logits from compute-dtype operands (the reference's
    ``preferred_element_type=float32`` over ``cd`` operands)."""
    return x.float() @ params["embed"].to(cd).float().T


def forward(params, tokens, config: TransformerConfig):
    """tokens [B, T] int -> (logits [B, T, V] f32, aux loss 0). The
    full-sequence forward (non-MoE, one device): the oracle prefill and
    decode are checked against."""
    cd = config.compute_dtype()
    t = tokens.shape[1]
    x = _embed(params, tokens, slice(0, t), cd)
    for block in params["blocks"]:
        x, _ = _block_forward_kv(x, block, config)
    x = _layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    return _lm_head(x, params, cd), torch.zeros((), device=x.device)


def init_kv_cache(config: TransformerConfig, batch: int,
                  max_len: Optional[int] = None, dtype=None,
                  device=None):
    """Zeroed per-layer K/V cache ``{"k", "v"}``, each
    ``[L, B, S, H, Dh]``. ``max_len`` is the slab capacity (defaults to
    ``config.seq_len``). ``device`` is required in practice: the CPU
    only when the caller names it."""
    s = int(max_len or config.seq_len)
    shape = (config.layers, batch, s, config.heads, config.head_dim)
    dtype = dtype if dtype is not None else config.compute_dtype()
    device = resolve(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(params, tokens, lengths, config: TransformerConfig,
            cache=None):
    """Run the prompt through the stack once, capturing per-layer K/V.

    tokens ``[B, T]`` int (right-padded); lengths ``[B]`` actual
    prompt lengths (1 <= lengths <= T). Returns ``(logits [B, V] f32
    at each sequence's last real position, cache)``. ``cache`` is the
    ``init_kv_cache`` dict with positions ``[0, T)`` written IN PLACE
    (the reference returns an updated copy of a donated buffer; pad
    positions hold K/V that every reader masks by length), or a fresh
    exactly-``T`` cache when ``cache=None``."""
    b, t = tokens.shape
    if t > config.seq_len:
        raise ValueError("prompt length %d exceeds seq_len %d"
                         % (t, config.seq_len))
    if cache is not None and cache["k"].shape[2] < t:
        raise ValueError("cache capacity %d < prompt length %d"
                         % (cache["k"].shape[2], t))
    cd = config.compute_dtype()
    lengths = torch.as_tensor(lengths, device=tokens.device)
    x = _embed(params, tokens, slice(0, t), cd)
    ks, vs = [], []
    for block in params["blocks"]:
        x, (k, v) = _block_forward_kv(x, block, config)
        ks.append(k)
        vs.append(v)
    x = _layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    idx = torch.clamp(lengths.long() - 1, 0, t - 1)
    x_last = x[torch.arange(b, device=x.device), idx]
    logits = _lm_head(x_last, params, cd)
    if cache is None:
        return logits, {"k": torch.stack(ks).to(cd),
                        "v": torch.stack(vs).to(cd)}
    for layer, (k, v) in enumerate(zip(ks, vs)):
        cache["k"][layer, :, :t] = k
        cache["v"][layer, :, :t] = v
    return logits, cache


def decode_step(params, tokens, cache, lengths,
                config: TransformerConfig, active=None):
    """One autoregressive step for the whole batch: embed the incoming
    token at its sequence's position, write its K/V into the cache IN
    PLACE (where the reference updates a donated buffer), and
    flash-decode every layer against the grown cache.

    tokens ``[B]`` int (the last emitted token per sequence);
    ``lengths`` ``[B]`` int32 — valid cache entries BEFORE this step;
    ``active`` optional ``[B]`` bool — inactive rows still compute
    (and write K/V at their clipped position) but keep their length.
    Returns ``(logits [B, V] f32, cache, new_lengths)``."""
    cd = config.compute_dtype()
    b = tokens.shape[0]
    s = cache["k"].shape[2]
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=tokens.device)
    pos_idx = torch.clamp(lengths, 0, config.seq_len - 1).long()
    x = _embed(params, tokens, pos_idx, cd)[:, None]
    write_idx = torch.clamp(lengths, 0, s - 1).long()
    new_len = torch.clamp(lengths + 1, max=s)
    rows = torch.arange(b, device=tokens.device)
    for layer, block in enumerate(params["blocks"]):
        kc, vc = cache["k"][layer], cache["v"][layer]
        h = _layer_norm(x, block["ln1"]["g"], block["ln1"]["b"])
        q, k, v = _qkv(h, block, config)                  # [B,1,H,Dh]
        kc[rows, write_idx] = k[:, 0].to(kc.dtype)
        vc[rows, write_idx] = v[:, 0].to(vc.dtype)
        attn = flash_decode(q[:, 0], kc, vc, new_len,
                            block_k=config.block_k,
                            impl=config.attention_impl)
        x = x + attn.reshape(b, 1, -1) @ block["proj"].to(cd)
        h = _layer_norm(x, block["ln2"]["g"], block["ln2"]["b"])
        x = x + _ffn(h, block, config)
    x = _layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"])[:, 0]
    logits = _lm_head(x, params, cd)
    if active is not None:
        new_len = torch.where(active, new_len, lengths)
    return logits, cache, new_len
