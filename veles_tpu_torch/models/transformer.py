"""Transformer language model: training (loss, Adam,
:class:`TransformerTrainer`), prefill, slab decode, and paged decode
with the speculative verify step.

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
:func:`prefill`, :func:`forward` and the training loss, whose gradient
runs the K2/K3 backward kernels, the K4 decode kernel in
:func:`decode_step` and the K5 paged decode kernel in
:func:`paged_decode_step`, on CUDA tensors; their plain PyTorch
versions on CPU tensors. :func:`verify_step` attends through
``flash_verify_paged``, plain on every device as in the reference.

The serving steps read :func:`compute_weights`: the weight matrices
cast to the compute dtype once, where the reference casts them inside
its compiled step (the same rounding, so the same numbers). On a CUDA
device :class:`TransformerTrainer` captures its train step into a CUDA
graph (``veles_tpu_torch.graphs``) and replays it, once per step.

Given a mesh (``parallel.mesh``), :class:`TransformerTrainer` trains
SPMD, one process a rank, as the reference's meshed trainer: the token
batch over ``data``; the sequence over ``seq``, attention then a ring
(``parallel.ring_attention``, K1-K3 on every hop); the experts of a
mixture over ``model``. Each rank's objective is its tokens' share of
the global token mean, and one all-reduce of one flat buffer over
``data x seq`` sums the gradients. On a mesh of more than one rank the
step runs eagerly (see :class:`TransformerTrainer`). The serving steps
(:func:`prefill`, :func:`decode_step`, :func:`paged_decode_step`,
:func:`verify_step`) take a :class:`ServeContext`: tensor parallelism
over a mesh's ``model`` axis, each rank on its ``H/tp`` heads (the
layouts of ``serve/sharding.py``). Under an AOT plan
(``aot/warmup.py``) each captured (or first eager) step of a token
shape hands its record to the plan as ``lm_step_many/<shape>``; the
step runs as it would without one. A trainer whose ``sched_tenant``
is set runs each ``step``/``step_many`` as one quantum of a shared
device (``veles_tpu_torch.sched``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from veles_tpu_torch import graphs
from veles_tpu_torch.aot import export as aot_export
from veles_tpu_torch.aot import warmup as aot_warmup
from veles_tpu_torch.config import get, root
from veles_tpu_torch.device import compute_dtype as _compute_dtype
from veles_tpu_torch.device import resolve
from veles_tpu_torch.graphs import StepGraph, use_graphs
from veles_tpu_torch.obs import profile as obs_profile
from veles_tpu_torch.ops import launches
from veles_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_decode,
                                                 flash_decode_paged,
                                                 flash_verify_paged)
from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel.fused import NonFiniteSentinel, update_ok
from veles_tpu_torch.parallel.mesh import check_mesh
from veles_tpu_torch.parallel.ring_attention import (attention_reference,
                                                   ring_attention_local)
from veles_tpu_torch.sched import quantum_or_null


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    embed: int = 128
    heads: int = 4
    layers: int = 2
    seq_len: int = 128
    mlp_ratio: int = 4
    #: >0 turns the FFN into a top-1-routed mixture of experts (the
    #: dense formulation: every expert runs on every token, the gate
    #: masks the combine).
    moe_experts: int = 0
    moe_aux_weight: float = 1e-2
    #: "float32" | "bfloat16": the activation dtype (f32 master
    #: params, f32 layer-norm stats and logits either way).
    compute: str = "float32"
    #: "flash" (the K1-K3 kernels on the card) or "dense": the
    #: quadratic causal oracle on one device (plain PyTorch, for
    #: debugging and parity; it refuses a ``seq`` mesh axis).
    attention: str = "flash"
    #: Force the flash implementation: "plain" | "cuda" | None (auto:
    #: the kernels on CUDA tensors, the plain path on CPU tensors).
    attention_impl: Optional[str] = None
    #: Tiles of the plain flash path; None = ops.flash_attention
    #: defaults. The kernels tile on their own.
    block_q: Optional[int] = None
    block_k: Optional[int] = None
    #: Kept so a configuration reads the same in both packages: the
    #: port runs layers as a Python loop either way (the reference's
    #: ``lax.scan`` changes nothing numerically).
    scan_layers: bool = True
    #: "attn" keeps only the block inputs and the attention branch's
    #: output for the backward and recomputes the rest; "none" keeps
    #: everything.
    remat: str = "attn"
    #: Cross-entropy sequence chunking: None = auto (chunk when
    #: T*vocab is material), 0 = always full logits, >0 = chunk size
    #: (must divide T).
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


def _expected_shapes(config: TransformerConfig,
                     experts: Optional[int] = None) -> Dict[str, Any]:
    e, m = config.embed, config.embed * config.mlp_ratio
    ln = {"g": (e,), "b": (e,)}
    block = {"ln1": ln, "qkv": (e, 3 * e), "proj": (e, e), "ln2": ln}
    if config.moe_experts > 0:
        n_exp = config.moe_experts
        held = n_exp if experts is None else experts
        block.update(gate=(e, n_exp), mlp_in=(held, e, m),
                     mlp_out=(held, m, e))
    else:
        block.update(mlp_in=(e, m), mlp_out=(m, e))
    return {"embed": (config.vocab, e), "pos": (config.seq_len, e),
            "ln_f": ln, "blocks": [block] * config.layers}


def params_from_numpy(tree, config: TransformerConfig, device,
                      experts: Optional[int] = None) -> Dict[str, Any]:
    """The JAX package's parameter tree (``init_params`` output, or
    ``jax.tree.map(np.asarray, trainer.params)``) -> the port's tree of
    f32 tensors on ``device``, same structure, same ``[in, out]``
    layouts. Tensor leaves are copied (detached), never aliased: a
    trainer updates its tensors in place, and a tree taken from it
    must not move with it. ``experts``: the experts a block holds, where
    an expert-parallel rank holds fewer than ``config.moe_experts``.
    Raises ``ValueError`` when the tree does not fit ``config``."""
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
            leaf = node.detach().to(device=device, dtype=torch.float32,
                                    copy=True)
        else:
            leaf = torch.from_numpy(
                np.array(node, dtype=np.float32, order="C")).to(device)
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError("params_from_numpy: %s has shape %s, config "
                             "wants %s" % (path, tuple(leaf.shape), shape))
        return leaf

    return convert(tree, _expected_shapes(config, experts), "")


#: the weight matrices, which every step reads in the compute dtype
_MATRICES = ("qkv", "proj", "mlp_in", "mlp_out", "gate")


def compute_weights(params, config: TransformerConfig) -> Dict[str, Any]:
    """The weights the serving steps read: ``params`` with each matrix
    cast to the compute dtype once, plus the tied LM head's operand
    (the embedding rounded to the compute dtype, in f32) under
    ``"head"``. Embeddings and layer norms stay the f32 leaves of
    ``params``; at f32 compute every leaf IS the params' own. After an
    in-place change of ``params``, :func:`refresh_weights`."""
    cd = config.compute_dtype()
    blocks = [{key: leaf.to(cd) if key in _MATRICES else leaf
               for key, leaf in block.items()}
              for block in params["blocks"]]
    return dict(params, blocks=blocks, head=params["embed"].to(cd).float())


@torch.no_grad()
def refresh_weights(weights, params, config: TransformerConfig) -> None:
    """Recompute :func:`compute_weights` INTO ``weights`` (copy_, so a
    captured step that reads them sees the new values)."""
    for dst, src in zip(_tree_leaves(weights),
                        _tree_leaves(compute_weights(params, config))):
        if dst is not src:
            dst.copy_(src)


def _layer_norm(x, g, b):
    xf = x.float()  # stats in f32 regardless of policy
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) / torch.sqrt(var + 1e-5) * g + b).to(x.dtype)


def _qkv(x, block, config: TransformerConfig):
    """x [B,T,E] -> (q, k, v) each [B,T,H,Dh]: strided views into one
    fused projection (the kernels read them in place). ``H`` is the
    heads the block's ``qkv`` holds: all of them, or a tensor-parallel
    rank's ``H/tp`` (its q, k and v columns by head)."""
    b, t, _ = x.shape
    cd = config.compute_dtype()
    heads = block["qkv"].shape[-1] // (3 * config.head_dim)
    qkv = x @ block["qkv"].to(cd)                         # [B,T,3E]
    qkv = qkv.view(b, t, 3, heads, config.head_dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _moe_ffn(h, block, config: TransformerConfig, par=None):
    """Top-1-routed mixture-of-experts FFN in the reference's dense
    formulation: every expert runs on every token and the gate masks
    the combine. Returns (y, aux) — aux is the Switch load-balance term
    E * sum_e(f_e * P_e).

    Expert-parallel (``par.expert``): the rank holds its run of experts
    (``mlp_in``/``mlp_out`` sliced on their expert dim over ``model``),
    computes them for every token, and the combine is summed over
    ``model``; the gate and its inputs are the same on every ``model``
    rank, so their cotangents are summed back (``pvary``). Over a token
    mesh f_e and P_e are the GLOBAL means (each rank's mean summed over
    ``data x seq``, shards being equal) before their product."""
    cd = config.compute_dtype()
    n_exp = config.moe_experts
    # gate logits in f32 from compute-dtype operands
    gates = torch.softmax(h.float() @ block["gate"].to(cd).float(), dim=-1)
    top1 = torch.argmax(gates, dim=-1)                      # [B,T]
    # one-hot by comparison: no check of the indices on the host, so
    # the step holds no sync and can be captured
    experts = torch.arange(n_exp, device=h.device)
    mask = (top1[..., None] == experts).float()             # [B,T,E]
    combine = (mask * gates).to(cd)
    if par is not None and par.expert:
        held = block["mlp_in"].shape[0]
        first = par.model.index * held
        h = collectives.pvary(h, par.model)
        combine = collectives.pvary(combine, par.model)[
            ..., first:first + held]
    hidden = torch.einsum("btd,edh->bteh", h, block["mlp_in"].to(cd))
    outs = torch.einsum("bteh,ehd->bted", F.gelu(hidden, approximate="tanh"),
                        block["mlp_out"].to(cd))
    y = torch.einsum("bted,bte->btd", outs, combine)
    frac = mask.mean(dim=(0, 1))           # tokens routed per expert
    prob = gates.mean(dim=(0, 1))          # mean gate mass per expert
    if par is not None:
        if par.expert or par.tensor:
            # a rank's experts, or its slice of every expert's hidden
            # features (tensor parallel): partial combines
            y = collectives.psum(y, par.model)
        if par.tokens.size > 1:
            frac = collectives.psum(frac, par.tokens) / par.tokens.size
            prob = collectives.psum(prob, par.tokens) / par.tokens.size
    return y, n_exp * torch.sum(frac * prob)


def _ffn(h, block, config: TransformerConfig, par=None):
    """The FFN branch; returns the residual delta: the dense gelu MLP
    (``jax.nn.gelu`` defaults to the tanh approximation, so does this)
    or the MoE combine with its aux term dropped."""
    if config.moe_experts > 0:
        return _moe_ffn(h, block, config, par)[0]
    cd = config.compute_dtype()
    h = F.gelu(h @ block["mlp_in"].to(cd), approximate="tanh")
    return _model_sum(h @ block["mlp_out"].to(cd), par)


def _model_sum(y, par):
    """A row-parallel layer's output: under tensor parallelism
    (``par.tensor``) each rank's product is a partial sum over its
    input features, summed over ``model``; else ``y`` as it is."""
    if par is not None and par.tensor:
        return collectives.psum(y, par.model)
    return y


def _out_proj(attn, block, cd, par):
    """The attention output ``[B, T, H*Dh]`` (this rank's heads)
    through ``proj``."""
    return _model_sum(attn @ block["proj"].to(cd), par)


def _attention_forward(x, block, config: TransformerConfig, par=None):
    """Pre-LN causal attention branch; returns (delta, k, v). Over a
    ``seq`` mesh axis (``par.seq``) it is the ring of this rank's
    chunk."""
    if config.attention not in ("flash", "dense"):
        raise ValueError("TransformerConfig.attention must be 'flash' "
                         "or 'dense', got %r" % (config.attention,))
    b, t, _ = x.shape
    cd = config.compute_dtype()
    h = _layer_norm(x, block["ln1"]["g"], block["ln1"]["b"])
    q, k, v = _qkv(h, block, config)
    if par is not None and par.seq.size > 1:
        if config.attention == "dense":
            # the seq ring IS the attention there: a dense oracle run
            # must drop the seq axis, not be silently ignored
            raise ValueError(
                "attention='dense' is single-device only; remove the "
                "mesh seq axis to compare against the oracle")
        out = ring_attention_local(q, k, v, par.seq, causal=True,
                                   impl=config.attention_impl,
                                   block_k=config.block_k)
    elif config.attention == "dense":
        out = attention_reference(q, k, v, causal=True)
    else:
        out = flash_attention(q, k, v, causal=True, block_q=config.block_q,
                              block_k=config.block_k,
                              impl=config.attention_impl)
    return _out_proj(out.reshape(b, t, -1), block, cd, par), k, v


def _block_forward_kv(x, block, config: TransformerConfig, par=None):
    """One pre-LN block that also returns its (k, v): the prefill
    body, the same ops in the same order as the full forward."""
    delta, k, v = _attention_forward(x, block, config, par)
    return _mlp_residual(x + delta, block, config, par), (k, v)


def _embed(params, tokens, positions, cd):
    return (params["embed"][tokens] + params["pos"][positions]).to(cd)


def _lm_head(x, params, cd):
    """f32 logits from compute-dtype operands (the reference's
    ``preferred_element_type=float32`` over ``cd`` operands); the
    head's operand is cached under ``"head"`` by
    :func:`compute_weights`."""
    head = params.get("head")
    if head is None:
        head = params["embed"].to(cd).float()
    return x.float() @ head.T


def forward(params, tokens, config: TransformerConfig):
    """tokens [B, T] int -> (logits [B, T, V] f32, moe aux loss). The
    full-sequence forward through :func:`_encode` (the training stack,
    one device): the oracle prefill and decode are checked against.
    Materializes the full logits; the loss goes through the chunked
    head of :func:`_loss`."""
    x, aux = _encode(params, tokens, config)
    return _lm_head(x, params, config.compute_dtype()), aux


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
            cache=None, par=None):
    """Run the prompt through the stack once, capturing per-layer K/V.

    tokens ``[B, T]`` int (right-padded); lengths ``[B]`` actual
    prompt lengths (1 <= lengths <= T). Returns ``(logits [B, V] f32
    at each sequence's last real position, cache)``. ``cache`` is the
    ``init_kv_cache`` dict with positions ``[0, T)`` written IN PLACE
    (the reference returns an updated copy of a donated buffer; pad
    positions hold K/V that every reader masks by length), or a fresh
    exactly-``T`` cache when ``cache=None``. ``par``: a
    :class:`ServeContext` (tensor parallelism: the cache holds this
    rank's heads)."""
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
        x, (k, v) = _block_forward_kv(x, block, config, par)
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
                config: TransformerConfig, active=None, par=None):
    """One autoregressive step for the whole batch: embed the incoming
    token at its sequence's position, write its K/V into the cache IN
    PLACE (where the reference updates a donated buffer), and
    flash-decode every layer against the grown cache.

    tokens ``[B]`` int (the last emitted token per sequence);
    ``lengths`` ``[B]`` int32 — valid cache entries BEFORE this step;
    ``active`` optional ``[B]`` bool — inactive rows still compute
    (and write K/V at their clipped position) but keep their length;
    ``par`` as :func:`prefill`'s.
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
        x = x + _out_proj(attn.reshape(b, 1, -1), block, cd, par)
        h = _layer_norm(x, block["ln2"]["g"], block["ln2"]["b"])
        x = x + _ffn(h, block, config, par)
    x = _layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"])[:, 0]
    logits = _lm_head(x, params, cd)
    if active is not None:
        new_len = torch.where(active, new_len, lengths)
    return logits, cache, new_len


# ---------------------------------------------------------------------------
# paged decode plane (block-table K/V over a shared page pool)
# ---------------------------------------------------------------------------

def init_paged_kv_cache(config: TransformerConfig, n_pages: int,
                        page_size: int, dtype=None, device=None):
    """Zeroed PAGED K/V pool ``{"k", "v"}``, each
    ``[L, n_pages + 1, page_size, H, Dh]``: one physical pool shared by
    every sequence, where a per-sequence block table (see
    ``serve/paging.py``) names which pages, in order, hold that
    sequence's cache. Page ``n_pages`` is a TRASH page past the ones
    ``PagePool`` counts: every write the reference drops (``mode=
    "drop"`` on the out-of-range sentinel page ``n_pages``) lands there
    instead, so no index the port forms is ever out of range, and no
    read looks at it (reads clamp page ids to ``n_pages - 1`` and mask
    by length). ``device`` as in :func:`init_kv_cache`."""
    shape = (config.layers, int(n_pages) + 1, int(page_size),
             config.heads, config.head_dim)
    dtype = dtype if dtype is not None else config.compute_dtype()
    device = resolve(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _paged_targets(cache, block_tables, pos, active):
    """(page, offset) of the K/V rows at positions ``pos`` ([B] or
    [B, K1]) through the block tables; rows of inactive sequences go to
    the trash page ``n_pages`` (the reference drops them)."""
    n_pages = cache["k"].shape[1] - 1
    ps = cache["k"].shape[2]
    n_blk = block_tables.shape[1]
    blk_idx = torch.clamp(pos // ps, 0, n_blk - 1).long()
    tables = block_tables.long()
    if pos.ndim == 1:
        page = tables.gather(1, blk_idx[:, None])[:, 0]
    else:
        page = tables.gather(1, blk_idx)
    page = torch.clamp(page, 0, n_pages)
    if active is not None:
        mask = active if pos.ndim == 1 else active[:, None]
        page = torch.where(mask, page, torch.full_like(page, n_pages))
    return page, (pos % ps).long(), n_pages


def paged_decode_step(params, tokens, cache, lengths, block_tables,
                      config: TransformerConfig, active=None, par=None):
    """One autoregressive step over PAGED K/V: write the new token's
    K/V IN PLACE into page ``block_tables[b, lengths[b] // page_size]``
    at offset ``lengths[b] % page_size``, then flash-decode every layer
    through the block table (the K5 kernel on CUDA tensors).

    tokens/lengths/active as :func:`decode_step`; ``cache`` the
    :func:`init_paged_kv_cache` pool; ``block_tables`` ``[B,
    n_blocks]`` int (entry ``n_pages`` = the unallocated sentinel:
    reads clamp it, an inactive row's write goes to the trash page);
    ``par`` as :func:`prefill`'s.
    Returns ``(logits [B, V] f32, cache, new_lengths)``."""
    cd = config.compute_dtype()
    b = tokens.shape[0]
    ps = cache["k"].shape[2]
    cap = block_tables.shape[1] * ps
    dev = tokens.device
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    block_tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                   device=dev)
    pos_idx = torch.clamp(lengths, 0, config.seq_len - 1).long()
    x = _embed(params, tokens, pos_idx, cd)[:, None]
    page, off, n_pages = _paged_targets(cache, block_tables, lengths,
                                        active)
    new_len = torch.clamp(lengths + 1, max=cap)
    for layer, block in enumerate(params["blocks"]):
        kc, vc = cache["k"][layer], cache["v"][layer]
        h = _layer_norm(x, block["ln1"]["g"], block["ln1"]["b"])
        q, k, v = _qkv(h, block, config)                  # [B,1,H,Dh]
        kc[page, off] = k[:, 0].to(kc.dtype)
        vc[page, off] = v[:, 0].to(vc.dtype)
        attn = flash_decode_paged(q[:, 0], kc[:n_pages], vc[:n_pages],
                                  block_tables, new_len,
                                  impl=config.attention_impl)
        x = x + _out_proj(attn.reshape(b, 1, -1), block, cd, par)
        h = _layer_norm(x, block["ln2"]["g"], block["ln2"]["b"])
        x = x + _ffn(h, block, config, par)
    x = _layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"])[:, 0]
    logits = _lm_head(x, params, cd)
    if active is not None:
        new_len = torch.where(active, new_len, lengths)
    return logits, cache, new_len


def verify_step(params, tokens, cache, lengths, block_tables,
                config: TransformerConfig, active=None, par=None):
    """The speculative-decode VERIFY step: a ``K1``-token chunk (the
    last committed token plus K draft proposals) through the target
    model in ONE batched step over the same pages as
    :func:`paged_decode_step`, with logits at every chunk position.

    tokens ``[B, K1]`` int; chunk position i sits at sequence position
    ``lengths[b] + i``: its K/V is written there, and its query attends
    positions ``< lengths[b] + i + 1`` (chunked causality as per-query
    lengths). Rejected proposals leave K/V beyond the accepted length;
    every later read masks it and real tokens overwrite it. ``par`` as
    :func:`prefill`'s. Returns ``(logits [B, K1, V] f32, cache)``;
    lengths are NOT advanced here."""
    cd = config.compute_dtype()
    b, k1 = tokens.shape
    dev = tokens.device
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    block_tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                   device=dev)
    pos = lengths[:, None] + torch.arange(k1, dtype=torch.int32,
                                          device=dev)      # [B,K1]
    pos_idx = torch.clamp(pos, 0, config.seq_len - 1).long()
    x = _embed(params, tokens, pos_idx, cd)
    page, off, n_pages = _paged_targets(cache, block_tables, pos, active)
    # query i attends its prefix AND itself: lengths + i + 1
    kv_len = pos + 1
    for layer, block in enumerate(params["blocks"]):
        kc, vc = cache["k"][layer], cache["v"][layer]
        h = _layer_norm(x, block["ln1"]["g"], block["ln1"]["b"])
        q, k, v = _qkv(h, block, config)                  # [B,K1,H,Dh]
        kc[page, off] = k.to(kc.dtype)
        vc[page, off] = v.to(vc.dtype)
        attn = flash_verify_paged(q, kc[:n_pages], vc[:n_pages],
                                  block_tables, kv_len)
        x = x + _out_proj(attn.reshape(b, k1, -1), block, cd, par)
        h = _layer_norm(x, block["ln2"]["g"], block["ln2"]["b"])
        x = x + _ffn(h, block, config, par)
    x = _layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    return _lm_head(x, params, cd), cache


# ---------------------------------------------------------------------------
# training: blocks with remat, chunked loss, Adam, the trainer
# ---------------------------------------------------------------------------

def _attention_delta(x, block, config: TransformerConfig, par=None):
    return _attention_forward(x, block, config, par)[0]


def _mlp_residual(x, block, config: TransformerConfig, par=None):
    h = _layer_norm(x, block["ln2"]["g"], block["ln2"]["b"])
    return x + _ffn(h, block, config, par)


def _block_forward(x, block, config: TransformerConfig, par=None):
    """One pre-LN block (attention + MLP residual branches)."""
    x = x + _attention_delta(x, block, config, par)
    return _mlp_residual(x, block, config, par)


def _maybe_remat(config: TransformerConfig, par=None):
    """The block body under the config's remat policy. "attn" runs the
    attention branch and the MLP branch as two checkpointed regions:
    the backward keeps only their inputs — the block input and the
    block input plus the attention output, which is the reference's
    ``save_only_these_names("attn_out")`` boundary — and recomputes
    everything else (layer norms, projections, K1's forward)."""
    if config.remat not in ("attn", "none"):
        raise ValueError("TransformerConfig.remat must be 'attn' or "
                         "'none', got %r" % (config.remat,))

    def block_fn(x, block):
        if config.remat == "none" or not torch.is_grad_enabled():
            return _block_forward(x, block, config, par)
        x = x + checkpoint(_attention_delta, x, block, config, par,
                           use_reentrant=False, preserve_rng_state=False)
        return checkpoint(_mlp_residual, x, block, config, par,
                          use_reentrant=False, preserve_rng_state=False)

    return block_fn


def _encode(params, tokens, config: TransformerConfig, par=None,
            pos0: int = 0):
    """tokens [B, T] int -> (final hidden [B, T, E] after ln_f in the
    compute dtype, moe aux loss f32). The layer stack is a loop (the
    reference's ``lax.scan`` over stacked blocks computes the same);
    MoE blocks run unrematerialized, as in the reference. ``pos0``: the
    position of the first token (a ``seq`` rank's chunk offset)."""
    cd = config.compute_dtype()
    x = _embed(params, tokens, slice(pos0, pos0 + tokens.shape[1]), cd)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if config.moe_experts > 0:
        for block in params["blocks"]:
            x = x + _attention_delta(x, block, config, par)
            h = _layer_norm(x, block["ln2"]["g"], block["ln2"]["b"])
            y, aux = _moe_ffn(h, block, config, par)
            x = x + y
            aux_total = aux_total + aux
    else:
        step = _maybe_remat(config, par)
        for block in params["blocks"]:
            x = step(x, block)
    return (_layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"]),
            aux_total)


def _ce_chunk(config: TransformerConfig, t: int, par=None) -> int:
    """Resolved cross-entropy chunk length (0 = full logits). A
    sequence-sharded run keeps its chunk's full head, as the
    reference."""
    if config.ce_chunk == 0 or (par is not None and par.seq.size > 1):
        return 0
    if config.ce_chunk:
        return config.ce_chunk if t % config.ce_chunk == 0 else 0
    if t * config.vocab < (1 << 21):  # full f32 logits are immaterial
        return 0
    for chunk in (512, 256, 128, 64):
        if t % chunk == 0:
            return chunk
    return 0


def _chunk_nll(x, targets, params, cd):
    """Summed NLL of one sequence chunk: the tied head's f32 logits,
    log-softmax, the targets' entries."""
    logp = torch.log_softmax(_lm_head(x, params, cd), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].sum()


def _loss_parts(params, tokens, targets, config: TransformerConfig,
                par=None, pos0: int = 0):
    """(summed causal NLL f32, MoE aux f32) of the tokens. When the full
    [B, T, V] f32 logits would be material the head runs per sequence
    chunk, each chunk checkpointed: peak logits memory is one chunk,
    and the backward recomputes each chunk's logits instead of keeping
    them. The chunk NLLs sum in f32."""
    x, aux = _encode(params, tokens, config, par, pos0)
    cd = config.compute_dtype()
    b, t, _ = x.shape
    chunk = _ce_chunk(config, t, par)
    if chunk:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, t, chunk):
            xc, tc = x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
            if torch.is_grad_enabled():
                nll = checkpoint(_chunk_nll, xc, tc, params, cd,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                nll = _chunk_nll(xc, tc, params, cd)
            total = total + nll
        return total, aux
    return _chunk_nll(x, targets, params, cd), aux


def _loss(params, tokens, targets, config: TransformerConfig):
    """Mean causal cross-entropy + MoE aux (:func:`_loss_parts`, the
    NLL divided by ``b * t``)."""
    total, aux = _loss_parts(params, tokens, targets, config)
    return total / targets.numel() + config.moe_aux_weight * aux


#: Adam coefficients — module constants so the nan_policy="skip"
#: gated update (which routes them through scalar selects) can never
#: drift from the plain path's values.
_ADAM_B1 = 0.9
_ADAM_B2 = 0.999
_ADAM_EPS = 1e-8


def _bias_corrections(step: torch.Tensor, b1: float = _ADAM_B1,
                      b2: float = _ADAM_B2):
    """(1 - b1**step, 1 - b2**step) as f32 device scalars from the f32
    device step count, as the reference computes them from its f32
    step (a captured step must not bake the count in as a constant)."""
    return 1 - b1 ** step, 1 - b2 ** step


@torch.no_grad()
def _adam_update(p, g, m, v, corrections, lr, b1=_ADAM_B1, b2=_ADAM_B2,
                 eps=_ADAM_EPS):
    """The reference's Adam, ``p - lr * mhat / (sqrt(vhat) + eps)`` op
    for op (not ``torch.optim.Adam``, which rounds differently), with
    ``corrections`` from :func:`_bias_corrections` and ``lr`` an f32
    device scalar. It writes ``p``, ``m`` and ``v`` in place where the
    reference returns new arrays from donated buffers."""
    bc1, bc2 = corrections
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * g * g)
    p.copy_(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))


@torch.no_grad()
def _adam_update_gated(p, g, m, v, corrections, lr, ok):
    """``nan_policy="skip"``: Adam neutralized in its own arithmetic on
    a bad step (sanitized g = 0, betas -> 1, lr -> 0) instead of a
    branch, so the host never reads ``ok``; a bad step leaves p, m and
    v bitwise unchanged. Bias correction keeps the constant betas."""
    bc1, bc2 = corrections
    b1_t = torch.where(ok, _ADAM_B1, 1.0)
    c1_t = torch.where(ok, 1 - _ADAM_B1, 0.0)
    b2_t = torch.where(ok, _ADAM_B2, 1.0)
    c2_t = torch.where(ok, 1 - _ADAM_B2, 0.0)
    lr_t = torch.where(ok, lr, 0.0)
    g = torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device))
    m.copy_(b1_t * m + c1_t * g)
    v.copy_(b2_t * v + c2_t * g * g)
    p.copy_(p - lr_t * (m / bc1) / (torch.sqrt(v / bc2) + _ADAM_EPS))


def _tree_leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves of a params-shaped tree in a fixed order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in _tree_leaves(node)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, node) for key, node in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, node) for node in tree]
    return fn(tree)


class _Par:
    """The mesh of a trainer's step: the ``seq`` ring, the token axes
    ``data x seq`` (gradients and the MoE statistics are summed over
    them) and ``model`` (expert parallelism when the config has
    experts)."""

    def __init__(self, mesh, seq_axis: Optional[str],
                 config: TransformerConfig) -> None:
        self.mesh = mesh
        seq = seq_axis if seq_axis in mesh.shape else None
        self.seq_name = seq
        self.seq = mesh.axis(*((seq,) if seq else ()))
        self.tokens = mesh.axis("data", *((seq,) if seq else ()))
        self.model = mesh.axis("model")
        self.expert = config.moe_experts > 0 and self.model.size > 1
        #: training replicates the dense weights over ``model``
        self.tensor = False
        if self.expert and config.moe_experts % self.model.size:
            raise ValueError("%d experts do not split over a 'model' axis "
                             "of %d" % (config.moe_experts, self.model.size))

    def tokens_of(self, tokens: torch.Tensor):
        """This rank's (inputs, targets, first position) of a global
        ``[B, T+1]`` batch: its ``data`` rows, shifted by one token, then
        its ``seq`` chunk of the T positions."""
        d, n_data = self.mesh.index("data"), self.mesh.size("data")
        b, t1 = tokens.shape
        if b % n_data:
            raise ValueError("a batch of %d does not split over 'data' %d"
                             % (b, n_data))
        rows = tokens[d * (b // n_data):(d + 1) * (b // n_data)]
        t = t1 - 1
        if t % self.seq.size:
            raise ValueError("%d positions do not split over '%s' %d"
                             % (t, self.seq_name, self.seq.size))
        chunk = t // self.seq.size
        pos0 = self.seq.index * chunk
        return (rows[:, pos0:pos0 + chunk], rows[:, pos0 + 1:pos0 + chunk + 1],
                pos0)


class ServeContext:
    """The serving steps' place on a mesh, the counterpart of the
    trainer's ``_Par``: tensor parallelism over the ``model`` axis.
    Each rank holds ``H/tp`` heads (its ``qkv`` columns by head and its
    rows of ``proj``), its columns of ``mlp_in`` and rows of
    ``mlp_out`` (of every expert, for a mixture), and its heads of the
    K/V cache (``serve/sharding.py``); the outputs of ``proj`` and
    ``mlp_out`` are partial sums, summed over ``model``. Embeddings,
    layer norms and the LM head are replicated, so every rank computes
    the same logits. ``expert=True``: the ranks hold runs of whole
    experts instead (an expert-parallel trainer's weights) and the MoE
    combine is what sums. Every rank of the axis runs every step."""

    def __init__(self, mesh, expert: bool = False) -> None:
        self.model = mesh.axis("model")
        self.expert = bool(expert) and self.model.size > 1
        self.tensor = self.model.size > 1 and not self.expert
        # no sequence ring and no token axes: every rank sees the
        # whole batch
        self.seq = self.tokens = mesh.axis()


class TransformerTrainer:
    """Owns f32 master params and Adam state on one device; one train
    step = forward + chunked loss + backward + Adam, in place.

    >>> trainer = TransformerTrainer(config, device="cuda")
    >>> metrics = trainer.step(tokens)   # tokens [B, T+1] int

    ``nan_policy`` is "warn" (count on the device, log 4 dispatches
    late), "skip" (a non-finite step leaves params and m/v bitwise
    intact, decided on the device) or "raise" (sync and raise); None
    reads ``root.common.train.nan_policy`` (default "warn").

    ``cuda_graphs`` (None = on a CUDA device): the step is captured
    into one CUDA graph per token-batch shape at its first call, and
    every :meth:`step` replays it; :meth:`step_many` replays it K times
    with no host sync between. The step count and the learning rate
    are f32 device scalars that the graph reads (the eager step reads
    the same), so captured and eager steps compute the same numbers.
    A capture that fails raises; ``cuda_graphs=False`` runs eagerly.

    ``sched_tenant`` (a ``TenantHandle``, None = free-running): every
    ``step``/``step_many`` dispatch, a captured step's first capture
    included, runs as ONE scheduler quantum; leases are revocable only
    between quanta, so the trajectory stays bitwise that of an
    unscheduled run.

    ``mesh`` (a ``parallel.mesh.Mesh``; its device is the trainer's):
    SPMD over the mesh's ranks, every rank calling :meth:`step` with
    the same GLOBAL ``[B, T+1]`` tokens. The rows shard over ``data``;
    over ``seq_axis`` each rank takes its chunk of the inputs and the
    targets after the one-token shift and attends through the ring;
    with ``moe_experts`` the experts shard over ``model``. Params are
    replicated but for the experts; each rank's objective is its
    tokens' NLL over the global token count plus the (global) MoE aux
    term, so the gradients summed over ``data x seq`` (one flat
    all-reduce, the loss in it) are the one-device gradients. On a mesh
    of more than one rank the step runs eagerly: a step whose
    collectives are host-staged (gloo) cannot be captured, and
    ``cuda_graphs=True`` raises there.
    """

    def __init__(self, config: TransformerConfig, device=None,
                 learning_rate: float = 3e-4, seed: int = 0,
                 steps_per_dispatch: int = 1,
                 nan_policy: Optional[str] = None,
                 cuda_graphs: Optional[bool] = None, mesh=None,
                 seq_axis: Optional[str] = "seq") -> None:
        check_mesh(mesh)
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError("device %s is not the mesh's %s"
                                 % (device, mesh.device))
            device = mesh.device
        self.device = resolve(device)
        if nan_policy is None:
            nan_policy = get(root.common.train.nan_policy, "warn")
        self.config = config
        self.mesh = mesh
        self._par = None
        if mesh is not None and mesh.n_devices > 1:
            if cuda_graphs:
                raise ValueError(
                    "cuda_graphs=True on a mesh of %d ranks: the step's "
                    "collectives (%s) run on the host and cannot be "
                    "captured; the meshed step runs eagerly"
                    % (mesh.n_devices, mesh.backend))
            cuda_graphs = False
            self._par = _Par(mesh, seq_axis, config)
        self._graphs_on = use_graphs(cuda_graphs, self.device)
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1, got %d" %
                             steps_per_dispatch)
        #: accepted for the reference's signature: :meth:`step_many`
        #: takes K from its tokens and replays the captured step K
        #: times, whatever this says
        self.steps_per_dispatch = int(steps_per_dispatch)
        self._sentinel = NonFiniteSentinel(nan_policy,
                                           "TransformerTrainer")
        self.nan_policy = nan_policy
        #: multi-tenant device sharing (veles_tpu_torch.sched): when set
        #: to a TenantHandle, every step/step_many dispatch runs as ONE
        #: scheduler quantum
        self.sched_tenant = None
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._step = torch.zeros((), dtype=torch.float32,
                                 device=self.device)
        self.learning_rate = learning_rate
        #: captured steps by token-batch shape, sharing one pool
        self._graphs: Dict[Any, StepGraph] = {}
        self._pool = None
        #: token shapes whose eager step made its AOT record
        self._eager_noted: set = set()
        self.aot_hits = self.aot_misses = self.aot_fallbacks = 0
        self.params: Optional[Dict[str, Any]] = None
        self.load_state(init_params(config, seed))

    @property
    def learning_rate(self) -> float:
        return self._lr_value

    @learning_rate.setter
    def learning_rate(self, value: float) -> None:
        """Takes effect from the next step, captured or not (the graph
        reads the device scalar)."""
        self._lr_value = float(value)
        self._lr.fill_(self._lr_value)

    def load_state(self, params, opt_m=None, opt_v=None,
                   step: int = 0) -> None:
        """Take params (and Adam m, v and the step count) from numpy
        trees or tensors, e.g. a JAX trainer's state through
        ``jax.tree.map(np.asarray, ...)``: training continues where
        that trainer stopped. Missing m/v start at zero. After the
        first call the values are copied into the trainer's tensors,
        which a captured step reads."""
        held = None
        if self._par is not None and self._par.expert:
            held = self.config.moe_experts // self._par.model.size
        new = params_from_numpy(self._held(params), self.config,
                                self.device, held)

        def state(tree):
            if tree is None:
                return [torch.zeros_like(p) for p in _tree_leaves(new)]
            return _tree_leaves(params_from_numpy(
                self._held(tree), self.config, self.device, held))

        m, v = state(opt_m), state(opt_v)
        if self.params is None:
            self.params = new
            for leaf in _tree_leaves(self.params):
                leaf.requires_grad_(True)
            self.opt_m = _tree_map(torch.zeros_like, self.params)
            self.opt_v = _tree_map(torch.zeros_like, self.params)
        with torch.no_grad():
            for dst, src in zip(_tree_leaves(self.params) +
                                _tree_leaves(self.opt_m) +
                                _tree_leaves(self.opt_v),
                                _tree_leaves(new) + m + v):
                if dst is not src:
                    dst.copy_(src)
        self._step.fill_(float(step))
        self._step_count = int(step)

    def _held(self, tree):
        """An expert-parallel rank's part of a params-shaped tree: each
        block's ``mlp_in``/``mlp_out`` sliced to this rank's experts
        (a tree that holds only them already passes as it is)."""
        if self._par is None or not self._par.expert:
            return tree
        n = self._par.model.size
        held = self.config.moe_experts // n
        first = self._par.model.index * held
        blocks = []
        for block in tree["blocks"]:
            block = dict(block)
            for key in ("mlp_in", "mlp_out"):
                if block[key].shape[0] == self.config.moe_experts:
                    block[key] = block[key][first:first + held]
            blocks.append(block)
        return dict(tree, blocks=blocks)

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device).long()
        return torch.from_numpy(np.asarray(tokens, np.int64)).to(
            self.device)

    def _train_step(self, tokens: torch.Tensor):  # veles-jit: static
        """One step on the device, the captured body: advances the
        device step count, returns (loss, nonfinite flag). The params
        and Adam state it reads are bound once (``load_state`` binds
        them only while they are None, before any capture, and copies
        in place after)."""
        self._step.add_(1)
        corrections = _bias_corrections(self._step)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        params = _tree_leaves(self.params)
        loss = _loss(self.params, inputs, targets, self.config)
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        with torch.no_grad():
            ok = update_ok(loss, grads)
            for p, g, m, v in zip(params, grads, _tree_leaves(self.opt_m),
                                  _tree_leaves(self.opt_v)):
                if self.nan_policy == "skip":
                    _adam_update_gated(p, g, m, v, corrections, self._lr,
                                       ok)
                else:
                    _adam_update(p, g, m, v, corrections, self._lr)
        return loss, (~ok).to(torch.int32)

    def _mesh_grads(self, tokens: torch.Tensor):
        """(global loss, gradients summed over ``data x seq``) of this
        rank's share of the global batch ``tokens``."""
        par = self._par
        inputs, targets, pos0 = par.tokens_of(tokens)
        n_tokens = (tokens.shape[1] - 1) * tokens.shape[0]
        params = _tree_leaves(self.params)
        nll, aux = _loss_parts(self.params, inputs, targets, self.config,
                               par, pos0)
        nll = nll / n_tokens
        aux = self.config.moe_aux_weight * aux
        grads = torch.autograd.grad(nll + aux, params)
        summed = collectives.sum_flat(list(grads) + [nll.detach()[None]],
                                      par.tokens)
        return summed[-1][0] + aux.detach(), summed[:-1]

    def loss_and_grads(self, tokens):
        """(loss, gradients in ``params`` leaf order) of a global token
        batch under the current weights, nothing updated: on a mesh the
        global loss and this rank's summed gradients, as :meth:`step`
        computes them."""
        tokens = self._tokens(tokens)
        if self._par is not None:
            return self._mesh_grads(tokens)
        params = _tree_leaves(self.params)
        loss = _loss(self.params, tokens[:, :-1], tokens[:, 1:], self.config)
        return loss.detach(), list(torch.autograd.grad(loss, params))

    def _mesh_step(self, tokens: torch.Tensor):
        """The eager step on a mesh: the rank's gradients summed over the
        token axes, then Adam on the rank's params (the same update as
        :meth:`_train_step`)."""
        self._step.add_(1)
        corrections = _bias_corrections(self._step)
        loss, grads = self._mesh_grads(tokens)
        params = _tree_leaves(self.params)
        with torch.no_grad():
            ok = update_ok(loss, grads)
            if self._par.expert:
                # a rank's own experts: agree on the flag over ``model``
                bad = collectives.all_reduce_sum((~ok).float(),
                                                 self._par.model)
                ok = bad == 0
            for p, g, m, v in zip(params, grads, _tree_leaves(self.opt_m),
                                  _tree_leaves(self.opt_v)):
                if self.nan_policy == "skip":
                    _adam_update_gated(p, g, m, v, corrections, self._lr,
                                       ok)
                else:
                    _adam_update(p, g, m, v, corrections, self._lr)
        return loss, (~ok).to(torch.int32)

    def eval_loss(self, tokens) -> torch.Tensor:
        """The loss of a global token batch without a step (0-d f32
        device tensor; on a mesh the global loss on every rank)."""
        tokens = self._tokens(tokens)
        with torch.no_grad():
            if self._par is None:
                return _loss(self.params, tokens[:, :-1], tokens[:, 1:],
                             self.config)
            inputs, targets, pos0 = self._par.tokens_of(tokens)
            nll, aux = _loss_parts(self.params, inputs, targets,
                                   self.config, self._par, pos0)
            nll = collectives.all_reduce_sum(
                nll / tokens[:, 1:].numel(), self._par.tokens)
            return nll + self.config.moe_aux_weight * aux

    def _run_step(self, tokens: torch.Tensor):
        """One step: a replay of the step captured for this batch shape
        (captured at its first call), or the eager step. The captured
        outputs are overwritten by the next replay: callers copy them."""
        shape = tuple(tokens.shape)
        if self._par is not None or not self._graphs_on:
            step = self._mesh_step if self._par is not None \
                else self._train_step
            if shape in self._eager_noted:
                return step(tokens)
            with launches.observing(self.device) as seen:
                out = step(tokens)
            self._eager_noted.add(shape)
            graphs.note_shape()
            self._aot_note(shape, tokens, seen, captured=False)
            return out
        graph = self._graphs.get(shape)
        if graph is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            state = (_tree_leaves(self.params) + _tree_leaves(self.opt_m) +
                     _tree_leaves(self.opt_v) + [self._step])
            graph = StepGraph(self._train_step, inputs=(tokens.clone(),),
                              keep=state, pool=self._pool)
            self._graphs[shape] = graph
            self._aot_note(shape, tokens, graph.tally())
        return graph.replay(tokens)

    def _aot_note(self, shape, tokens, tally, captured=True) -> None:
        """A step's capture record, ``lm_step_many/<B>x<T+1>``."""
        aot_warmup.note(
            self, partial(aot_export.transformer_trainer_fingerprint, self),
            "lm_step_many/%s" % "x".join(str(d) for d in shape), (tokens,),
            ("params", "opt_m", "opt_v", "step"), tally, captured,
            owner="trainer")

    def _quantum(self):
        """One scheduler quantum when this trainer is a tenant of a
        shared device; free-running otherwise."""
        return quantum_or_null(self.sched_tenant)

    # -- non-finite sentinel ------------------------------------------------
    @property
    def nonfinite_count(self) -> int:
        """Train steps whose loss or grads were non-finite so far
        (reading syncs the device accumulator)."""
        return self._sentinel.count

    def step(self, tokens) -> Dict[str, Any]:
        """tokens [B, T+1] int (inputs + shifted targets). Returns
        ``{"loss", "nonfinite"}`` as device tensors."""
        self._step_count += 1
        tokens = self._tokens(tokens)
        with self._quantum():
            loss, nonfinite = (x.clone() for x in self._run_step(tokens))
        self._sentinel.note(nonfinite)
        obs_profile.on_step()
        return {"loss": loss, "nonfinite": nonfinite}

    def step_many(self, tokens_k) -> Dict[str, Any]:
        """K train steps: ``tokens_k`` [K, B, T+1] int, on the device
        at once; each step is one replay fed by a device-to-device copy
        of its batch, with no host sync between. Returns ``{"loss":
        [K], "nonfinite": [K]}`` device tensors; numerics equal K
        sequential :meth:`step` calls (per-step bias correction)."""
        if isinstance(tokens_k, (list, tuple)):
            tokens_k = np.stack([np.asarray(t) for t in tokens_k])
        tokens_k = self._tokens(tokens_k)
        k = int(tokens_k.shape[0])
        losses = torch.empty(k, dtype=torch.float32, device=self.device)
        flags = torch.empty(k, dtype=torch.int32, device=self.device)
        with self._quantum():
            for i in range(k):
                loss, nonfinite = self._run_step(tokens_k[i])
                losses[i] = loss
                flags[i] = nonfinite
        self._step_count += k
        self._sentinel.note(flags)
        obs_profile.on_step(k)
        return {"loss": losses, "nonfinite": flags}

    def generate_logits(self, tokens) -> torch.Tensor:
        """Full-sequence logits [B, T, V] f32 under the current
        weights. On a mesh every rank passes the same global tokens and
        gets the same logits, through the serving forward
        (:class:`ServeContext` over ``model``): the heads and MLP
        features of the replicated weights split over ``model``, or the
        experts where the trainer holds them split; ``data`` and
        ``seq`` replicate it."""
        tokens = self._tokens(tokens)
        with torch.inference_mode():
            if self._par is None:
                return forward(self.params, tokens, self.config)[0]
            ctx = ServeContext(self.mesh, expert=self._par.expert)
            params = self.params
            if ctx.tensor:
                from veles_tpu_torch.serve.sharding import (
                    place_tree, transformer_param_shardings)
                params = place_tree(transformer_param_shardings(
                    self.mesh, params), params)
            x, _ = _encode(params, tokens, self.config, ctx)
            return _lm_head(x, params, self.config.compute_dtype())


#: The LM trainer under its workload name.
LMTrainer = TransformerTrainer
