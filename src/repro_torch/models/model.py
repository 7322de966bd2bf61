"""The model facade of the port (dense, moe, vlm, ssm, hybrid and encdec):
architecture + weights, the weight init, the token embedding, the LM head,
whisper's encoder (``encode``: sinusoidal rows added to the stub frontend's
frame embeddings, the bidirectional stack, the final norm), the static
engine's ``init_caches`` / ``encode`` / ``fill_cross_kv`` / ``prefill`` /
``decode_step``, and the training forward and loss. Counterpart of
``repro.models.model.Model`` (``init``, ``_encode``, ``_fill_cross_kv``,
``_embed``, ``_logits``, the static serving methods) and of its training
forward and loss, as module functions (``embed``, ``logits``,
``forward``, ``loss``, ``cross_entropy``) on an explicit weight dict, the
form the trainer differentiates. The static caches are a per-layer list
updated in place; ``prefill`` and ``decode_step`` return it beside the
logits, as JAX returns its new caches.

Weights are a plain nested dict of tensors with the JAX package's names,
except that the stacked ``blocks`` become a list with one dict per layer:

    embed.embedding [Vp, D]   final_norm.scale [D] (.bias: layernorm)
    out.head [D, Vp] (untied)   pos.pos_embedding [P, D] (learned positions)
    mlm.dense [D, D], mlm.bias [D], mlm.ln.{scale, bias} (BERT's MLM head)
    blocks[l]: ln1, attn.wqkv [D, q+2kv] (+ bqkv), attn.wo [q, D] (+ bo),
               ln2, mlp.w1 [D, F] (+ b1), mlp.w2 [F, D] (+ b2),
               mlp.w3 [D, F] (swiglu)
    blocks[l] of an ssm (mamba2) model: ln1 and mamba.{in_proj, conv,
               A_log, D, dt_bias, norm_scale, out_proj} (``models.ssm``)
    blocks[l] of a MoE layer: moe.router [D, E], moe.experts.{w1, w3}
               [E, D, F], moe.experts.w2 [E, F, D], moe.shared.{w1, w3}
               [D, Fs], moe.shared.w2 [Fs, D] (``models.moe``) in place of
               mlp; a hybrid layer's mixer is attn or mamba by its index
    encdec: enc_blocks[l] (attention blocks as above), enc_final_norm, and
               decoder blocks[l] with ln_x and xattn.{wq [D, q], wk, wv
               [D, kv], wo [q, D]} (+ bq, bk, bv, bo) besides their own
    a tensor-parallel rank's blocks (``Model.shard``): attn.{wq, wk, wv}
               split from wqkv and column-sliced, wo, mlp.w2 and the
               experts row- or expert-sliced (``parallel.sharding``)
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import resolve_device
from ..configs.base import ArchConfig, torch_dtype
from ..core.optrace import scope
from ..parallel import collectives, sharding
from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from . import transformer as tf
from .layers import (Params, apply_norm, dense, dense_init, embed_tokens,
                     gelu, init_norm, pad_vocab, sinusoidal_positions,
                     unembed, vocab_parallel_lookup)


def _normal(gen: torch.Generator, shape, device, dtype) -> torch.Tensor:
    """N(0, 0.02^2), the embedding tables' init."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0, generator=gen)
    return t.mul_(0.02).to(dtype)


def _zeros(n: int, device, dtype) -> torch.Tensor:
    return torch.zeros((n,), dtype=dtype, device=device)


def init_params(arch: ArchConfig, gen: torch.Generator, device,
                dtype: torch.dtype,
                block_fn: Optional[Callable[[Params], Params]] = None
                ) -> Params:
    """Random weights with the JAX package's distributions (not its bits:
    a parity test converts the JAX weights instead, see ``convert``).
    Biases start at zero, as in JAX. ``block_fn`` maps each decoder block
    as soon as it is made (the generator's draws are unchanged), so that
    only its result outlives the next block's init."""
    if block_fn is None:
        block_fn = lambda blk: blk  # noqa: E731
    if arch.mlp not in ("swiglu", "gelu"):
        raise NotImplementedError(
            f"{arch.name}: the port initializes swiglu/gelu MLPs only")
    d = arch.d_model
    p: Params = {"embed": {"embedding": _normal(
        gen, (pad_vocab(arch.vocab_size), d), device, dtype)}}
    if arch.pos_emb == "learned":
        p["pos"] = {"pos_embedding": _normal(gen, (arch.max_position, d),
                                             device, dtype)}
    encdec = arch.family == "encdec"
    if encdec:
        p["enc_blocks"] = [_init_block(gen, arch, 0, device, dtype)
                           for _ in range(arch.enc_layers)]
        p["enc_final_norm"] = init_norm(arch.norm, d, dtype, device)
    period = len(tf.layer_kinds(arch))
    p["blocks"] = [block_fn(_init_block(gen, arch, layer % period, device,
                                        dtype, cross=encdec))
                   for layer in range(arch.num_layers)]
    p["final_norm"] = init_norm(arch.norm, d, dtype, device)
    if not arch.tie_embeddings:
        p["out"] = {"head": dense_init(gen, d, pad_vocab(arch.vocab_size),
                                        device, dtype)}
    if arch.mlm_transform:
        p["mlm"] = {"dense": dense_init(gen, d, d, device, dtype),
                    "bias": _zeros(d, device, dtype),
                    "ln": init_norm(arch.norm, d, dtype, device)}
    return p


def _shard_block(arch: ArchConfig, rank: int, tp: int,
                 blk: Params) -> Params:
    return sharding.serving_shards([blk], arch, rank, tp)[0]


def _init_attn(gen: torch.Generator, arch: ArchConfig, device,
               dtype: torch.dtype, cross: bool = False) -> Params:
    """A self-attention's fused ``wqkv`` (+ ``bqkv``), or a cross-
    attention's separate ``wq``, ``wk``, ``wv`` (+ biases); then ``wo``."""
    d, qd, kvd = arch.d_model, arch.q_dim, arch.kv_dim
    names = (("wq", "bq", qd), ("wk", "bk", kvd), ("wv", "bv", kvd)) \
        if cross else (("wqkv", "bqkv", qd + 2 * kvd),)
    attn: Params = {}
    for w, b, n in names:
        attn[w] = dense_init(gen, d, n, device, dtype)
        if arch.use_bias:
            attn[b] = _zeros(n, device, dtype)
    attn["wo"] = dense_init(gen, qd, d, device, dtype)
    if arch.use_bias:
        attn["bo"] = _zeros(d, device, dtype)
    return attn


def _init_block(gen: torch.Generator, arch: ArchConfig, i: int, device,
                dtype: torch.dtype, cross: bool = False) -> Params:
    """Layer ``i`` of its period: its mixer (attention or mamba), a
    cross-attention with its norm where ``cross`` (whisper's decoder), and
    its MLP or MoE tail (none for mamba2)."""
    d = arch.d_model
    if tf.layer_kinds(arch)[i] == "mamba":
        blk = {"ln1": init_norm(arch.norm, d, dtype, device),
               "mamba": ssm_lib.init_mamba(gen, arch, device, dtype)}
        if arch.family == "ssm":        # mamba2 blocks: no ln2, no MLP
            return blk
    else:
        blk = {"ln1": init_norm(arch.norm, d, dtype, device),
               "attn": _init_attn(gen, arch, device, dtype)}
    if cross:
        blk["ln_x"] = init_norm(arch.norm, d, dtype, device)
        blk["xattn"] = _init_attn(gen, arch, device, dtype, cross=True)
    blk["ln2"] = init_norm(arch.norm, d, dtype, device)
    blk.update(_init_ffn(gen, arch, i, device, dtype))
    return blk


def _init_ffn(gen: torch.Generator, arch: ArchConfig, i: int, device,
              dtype: torch.dtype) -> Params:
    """``{"moe": ...}`` where layer ``i`` of its period holds a MoE, else
    ``{"mlp": ...}``."""
    if arch.is_moe_layer(i):
        return {"moe": moe_lib.init_moe(gen, arch, device, dtype)}
    d, f = arch.d_model, arch.d_ff
    mlp = {"w1": dense_init(gen, d, f, device, dtype),
           "w2": dense_init(gen, f, d, device, dtype)}
    if arch.mlp == "swiglu":
        mlp["w3"] = dense_init(gen, d, f, device, dtype)
    if arch.use_bias:
        mlp["b1"] = _zeros(f, device, dtype)
        mlp["b2"] = _zeros(d, device, dtype)
        if arch.mlp == "swiglu":
            mlp["b3"] = _zeros(f, device, dtype)
    return {"mlp": mlp}


def _full(par, w: torch.Tensor) -> torch.Tensor:
    return w if par is None else par.full(w)


def embed(arch: ArchConfig, params: Params, tokens: torch.Tensor,
          par=None) -> torch.Tensor:
    """tokens [B, S] -> [B, S, D] in the compute dtype, plus the learned
    position rows 0 .. S-1 where the arch has them. On a training mesh
    (``par``) the embedding's FSDP slices are gathered first and, with a
    model axis, the table is vocab-parallel (JAX's ("tensor", "fsdp")
    spec): each rank looks up the tokens of its vocab slice
    (``vocab_parallel_lookup``), and the ranks' rows meet in
    ``par.exit`` (a rank's rows of the sequence under sequence
    parallelism, which then take their own position rows)."""
    dtype = torch_dtype(arch.dtype)
    with scope("embed"):
        table = _full(par, params["embed"]["embedding"])
        if par is None or par.model is None:
            x = table.to(dtype)[tokens.long()]
            s0, s1 = 0, tokens.shape[1]
        else:
            x = par.exit(vocab_parallel_lookup(table, tokens.long(),
                                               par.mrank, dtype))
            s0, s1 = par.rows(tokens.shape[1])
        if arch.pos_emb == "learned":
            x = x + params["pos"]["pos_embedding"][s0:s1].to(dtype)
        return x


def encode(arch: ArchConfig, params: Params,
           frontend_embeddings: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over the stub frontend's frame embeddings [B,
    Senc, D]: sinusoidal rows added in the compute dtype, the
    bidirectional stack (its attention above ``attn_chunk`` frames chunked
    or flash, as ``attn_impl`` says), the final norm -> [B, Senc, D]."""
    dtype = torch_dtype(arch.dtype)
    x = frontend_embeddings.to(dtype)
    s = x.shape[1]
    x = x + sinusoidal_positions(s, arch.d_model, dtype, x.device)
    positions = torch.arange(s, device=x.device)[None]
    x, _ = tf.apply_stack(arch, params["enc_blocks"], x, positions,
                          causal=False)
    return apply_norm(arch.norm, params["enc_final_norm"], x)


def logits(arch: ArchConfig, params: Params, x: torch.Tensor,
           par=None) -> torch.Tensor:
    """Final norm (+ BERT's MLM transform) + LM head: [B, S, D] -> fp32
    logits [B, S, Vp]. On a training mesh with a model axis (``par``) the
    logits are the rank's vocab slice [B, S, Vp / tp] (the tied head is
    the vocab-parallel embedding's transpose, an untied head's columns
    its "tensor" dim), and the rows are whole, as JAX unshards the
    sequence before the head: under sequence parallelism the normed rows
    are gathered, else the head's input is ``copy_to``'d so the partial
    gradients of the ranks' vocab slices are summed."""
    with scope("logits"):
        model = par is not None and par.model is not None
        x = apply_norm(arch.norm, params["final_norm"], x)
        if model and par.seq:
            x = collectives.gather_seq(x, par.model)
        if arch.mlm_transform:
            mlm = params["mlm"]
            x = gelu(dense(x, _full(par, mlm["dense"]), mlm["bias"]))
            x = apply_norm(arch.norm, mlm["ln"], x)
        if model and not par.seq:
            x = collectives.copy_to(x, par.model)
        tied = _full(par, params["embed"]["embedding"]) \
            if arch.tie_embeddings else None
        out = params.get("out", {})
        if "head" in out:
            out = {"head": _full(par, out["head"])}
        return unembed(out, x, tied, arch.logit_softcap)


def forward(arch: ArchConfig, params: Params,
            batch: Dict[str, torch.Tensor], data_group=None, par=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward -> (fp32 logits [B, S, Vp], the auxiliary
    loss: the MoE layers' Switch losses summed, an fp32 scalar, 0 for
    every other family), as JAX's ``Model.forward``. ``batch`` may carry
    ``mrope_positions`` [3, B, S] (qwen2-vl) and must carry
    ``frontend_embeddings`` [B, Senc, D] for an encdec arch. With a
    ``data_group`` (``batch`` this rank's rows of a data-parallel batch)
    the Switch losses are the whole batch's (``moe.apply_moe``). On a
    training mesh (``par``) each rank runs its share of the layers
    (``transformer.apply_block``) and the logits are its vocab slice."""
    tokens = batch["tokens"]
    x = embed(arch, params, tokens, par)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    enc_out = encode(arch, params, batch["frontend_embeddings"]) \
        if arch.family == "encdec" else None
    x, aux = tf.apply_stack(arch, params["blocks"], x, positions,
                            causal=not arch.bidirectional,
                            mrope_positions=batch.get("mrope_positions"),
                            enc_out=enc_out, data_group=data_group,
                            par=par)
    return logits(arch, params, x, par), aux


def cross_entropy(lg: torch.Tensor, targets: torch.Tensor,
                  mask=None, denom=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean cross entropy and accuracy over every column of the
    padded vocab (as ``repro.models.model._ce_pieces``). JAX's custom VJP
    there shards the backward; its math is autodiff's, used here.
    ``denom`` (default: the mask's count, at least 1) divides the sums: a
    data-parallel rank passes the whole batch's count, so its ce and
    accuracy are its shares of the batch's."""
    lg = lg.float()
    lse = torch.logsumexp(lg, dim=-1)
    target_logit = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    ll = target_logit - lse
    correct = (target_logit >= lg.max(dim=-1).values).float()
    m = torch.ones_like(ll) if mask is None else mask.float()
    if denom is None:
        denom = torch.clamp_min(m.sum(), 1.0)
    ce = -(ll * m).sum() / denom
    acc = (correct * m).sum() / denom
    return ce, acc.detach()


class _VocabParallelCE(torch.autograd.Function):
    """JAX's ``_ce_loss`` custom VJP on a model rank's vocab slice of the
    fp32 logits [B, S, V / tp] (``_ce_pieces`` / ``_ce_loss_bwd``): the
    row max (an all-reduce of the ranks' maxima), then one all-reduce of
    each row's sum of exp(logit - max) and its target logit (the rank
    holding the target adds it, the others 0) give lse and the target
    logit; accuracy compares the target logit with the global max. Every
    padded column takes part, as in JAX. The backward is local:
    (softmax - onehot) * mask / denom on the rank's columns."""

    @staticmethod
    def forward(ctx, lg, targets, m, denom, group, lo):
        v = lg.shape[-1]
        gmax = collectives.all_reduce(lg.amax(dim=-1), group,
                                      op=torch.distributed.ReduceOp.MAX)
        local = targets.long() - lo
        inside = (local >= 0) & (local < v)
        picked = torch.gather(lg, -1, local.clamp(0, v - 1)[..., None])[..., 0]
        both = collectives.all_reduce(torch.stack([
            torch.exp(lg - gmax[..., None]).sum(dim=-1),
            torch.where(inside, picked, torch.zeros_like(picked))]), group)
        lse = gmax + torch.log(both[0])
        target_logit = both[1]
        ll = target_logit - lse
        correct = (target_logit >= gmax).float()
        ce = -(ll * m).sum() / denom
        acc = (correct * m).sum() / denom
        ctx.save_for_backward(lg, lse, local, inside, m, denom)
        return ce, acc

    @staticmethod
    def backward(ctx, g_ce, g_acc):
        lg, lse, local, inside, m, denom = ctx.saved_tensors
        dl = torch.exp(lg - lse[..., None])
        onehot = torch.zeros_like(dl).scatter_(
            -1, local.clamp(0, lg.shape[-1] - 1)[..., None],
            inside[..., None].to(dl.dtype))
        return ((dl - onehot) * (g_ce * m / denom)[..., None],
                None, None, None, None, None)


def vocab_parallel_cross_entropy(lg: torch.Tensor, targets: torch.Tensor,
                                 mask=None, denom=None, *, group, rank: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cross_entropy`` of the model rank ``rank``'s vocab slice ``lg``
    [B, S, Vp / tp] (``_VocabParallelCE``): the same masked means, every
    model rank the same values."""
    lg = lg.float()
    m = torch.ones(targets.shape, dtype=torch.float32, device=lg.device) \
        if mask is None else mask.float()
    if denom is None:
        denom = torch.clamp_min(m.sum(), 1.0)
    denom = torch.as_tensor(denom, dtype=torch.float32, device=lg.device)
    ce, acc = _VocabParallelCE.apply(lg, targets, m, denom, group,
                                     rank * lg.shape[-1])
    return ce, acc.detach()


def loss(arch: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
         group=None, denom=None, par=None
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (ce + aux, metrics {loss, ce, aux, accuracy}): the masked cross
    entropy plus the auxiliary loss, as JAX's ``Model.loss``. A
    data-parallel rank passes its data ``group`` and the whole batch's
    mask count ``denom``: then ce and accuracy (and loss) are the rank's
    shares, which sum over the group to the batch's, and aux is the
    batch's; the gradients of the ranks' losses sum to the batch loss's.
    On a training mesh with a model axis (``par``) the cross entropy is
    vocab-parallel (``vocab_parallel_cross_entropy``)."""
    lg, aux = forward(arch, params, batch, group, par)
    with scope("loss"):
        if par is not None and par.model is not None:
            ce, acc = vocab_parallel_cross_entropy(
                lg, batch["targets"], batch.get("loss_mask"), denom,
                group=par.model, rank=par.mrank)
        else:
            ce, acc = cross_entropy(lg, batch["targets"],
                                    batch.get("loss_mask"), denom)
    total = ce + aux
    return total, {"loss": total.detach(), "ce": ce.detach(),
                   "aux": aux.detach(), "accuracy": acc}


class Model:
    """Architecture + weights on one device. ``shard`` is ``(rank, tp)``
    where the decoder blocks hold only that rank's tensor-parallel serving
    shards (``parallel.sharding.serving_shards``), None where every weight
    is whole."""

    def __init__(self, arch: ArchConfig, params: Params,
                 shard: Optional[Tuple[int, int]] = None):
        self.arch = arch
        self.params = params
        self.shard = shard
        self.dtype = torch_dtype(arch.dtype)
        self.device = params["embed"]["embedding"].device

    @classmethod
    def init(cls, arch: ArchConfig, generator: torch.Generator,
             device="cuda",
             shard: Optional[Tuple[int, int]] = None) -> "Model":
        """Seeded random weights built directly on ``device`` in the
        config's dtype; ``generator`` must live on that device. With
        ``shard=(rank, tp)`` each block is cut to the rank's shards as soon
        as it is made, so the device holds one whole block at a time, never
        the whole stack; the shards are the whole model's slices bit for
        bit (the same draws)."""
        block_fn = None
        if shard is not None:
            block_fn = functools.partial(_shard_block, arch, *shard)
        return cls(arch, init_params(arch, generator, resolve_device(device),
                                     torch_dtype(arch.dtype), block_fn),
                   shard)

    def sharded(self, rank: int, tp: int) -> "Model":
        """This whole model's rank ``rank`` of ``tp``: the decoder blocks
        cut to the rank's serving shards, every other leaf the same tensor.
        The whole blocks stay this model's: drop it to free them."""
        if self.shard is not None:
            raise ValueError(f"the model already holds rank {self.shard[0]}"
                             f" of {self.shard[1]}'s shards")
        params = dict(self.params)
        params["blocks"] = sharding.serving_shards(params["blocks"],
                                                   self.arch, rank, tp)
        return Model(self.arch, params, (rank, tp))

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> [B, S, D] in the compute dtype (rope models add
        no position embedding here)."""
        return embed(self.arch, self.params, tokens)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head: [B, S, D] -> fp32 logits [B, S, Vp]."""
        return logits(self.arch, self.params, x)

    # --------------------------------------------------- static serving ----
    def init_caches(self, batch: int, max_len: int) -> List[Params]:
        """The static engine's per-layer caches (``transformer.
        init_caches``) on the model's device, in the model dtype."""
        return tf.init_caches(self.arch, batch, max_len, self.dtype,
                              self.device)

    @torch.inference_mode()
    def encode(self, frontend_embeddings: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder (module ``encode``): frames [B, Senc, D] ->
        [B, Senc, D]."""
        return encode(self.arch, self.params, frontend_embeddings)

    @torch.inference_mode()
    def fill_cross_kv(self, caches: List[Params],
                      enc_out: torch.Tensor) -> List[Params]:
        """Project the encoder output once into every decoder layer's
        ``cross_k`` / ``cross_v`` (in place), as JAX's ``_fill_cross_kv``."""
        for blk, cache in zip(self.params["blocks"], caches):
            if "xattn" in blk:
                k, v = attn_lib.project_enc_kv(self.arch, blk["xattn"],
                                               enc_out)
                cache["cross_k"].copy_(k)
                cache["cross_v"].copy_(v)
        return caches

    @torch.inference_mode()
    def prefill(self, caches: List[Params], tokens: torch.Tensor,
                frontend_embeddings: Optional[torch.Tensor] = None,
                mrope_positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Params]]:
        """Fill ``caches`` (in place) from a [B, S] prompt -> (fp32 logits
        of the last position [B, 1, Vp], the same caches). An encdec arch
        given ``frontend_embeddings`` [B, Senc, D] first encodes them and
        fills the cross K/V (``encode``, ``fill_cross_kv``); without them
        the decoder reads the cross K/V already in ``caches``."""
        if self.arch.family == "encdec" and frontend_embeddings is not None:
            self.fill_cross_kv(caches, self.encode(frontend_embeddings))
        x = self._embed(tokens)
        positions = torch.zeros((tokens.shape[0],), dtype=torch.int64,
                                device=tokens.device)
        x = tf.decode_stack(self.arch, self.params["blocks"], caches, x,
                            positions, mrope_positions)
        return self._logits(x[:, -1:]), caches

    @torch.inference_mode()
    def decode_step(self, caches: List[Params], tokens: torch.Tensor,
                    positions: torch.Tensor,
                    mrope_positions: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, List[Params]]:
        """One token for every sequence: tokens [B, 1] at cache rows
        ``positions`` [B] -> (fp32 logits [B, 1, Vp], the same caches,
        updated in place). Learned positions are re-added at each
        sequence's own row."""
        arch = self.arch
        if arch.pos_emb == "learned":
            x = embed_tokens(self.params["embed"], tokens.long(), self.dtype) \
                + self.params["pos"]["pos_embedding"][positions.long()][
                    :, None].to(self.dtype)
        else:
            x = self._embed(tokens)
        x = tf.decode_stack(arch, self.params["blocks"], caches, x,
                            positions, mrope_positions)
        return self._logits(x), caches
