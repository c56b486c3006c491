"""Tensor- and expert-parallel transformer — the DP × TP (+ MoE) model.

Port of ``dmlc_core_tpu/models/tp_transformer.py``. The reference
annotates Megatron shardings and lets GSPMD insert the collectives; the
port has no partitioner, so each rank of a ("data", "model")
:class:`~dmlc_core_tpu_torch.device.sharding.ProcessMesh` holds its
shards and the layers are written as explicit Megatron layers:

- column-parallel ``qkv`` and ``w1`` behind ``copy_to_group`` (identity
  forward, all-reduce backward); row-parallel ``proj`` and ``w2``
  followed by ``psum_bcast`` (all-reduce forward, identity backward);
- ``qkv`` is sharded BY HEAD: each rank holds the q, k and v columns of
  its own heads. The reference's ``P(None, "model")`` cuts the [D, 3D]
  matrix into contiguous column blocks, which do not line up with heads
  once the product is reshaped to (3, H, hd) (at D=32, H=4, tp=4 block 0
  is q heads 0-2); GSPMD hides that with a reshard, the port cannot;
- MoE (``moe_experts > 0``): each rank holds E / tp whole experts and the
  replicated gate; it computes its experts' share of the reference's
  dense top-1 dispatch, and one ``psum_bcast`` sums the shares. The gate
  sits inside the parallel region, so its gradient on a rank is that
  rank's experts' part and is summed over "model" after the backward;
- the loss is ``nll.mean()`` over the global batch, so the gradients are
  summed over "data" (each rank's loss is its rows' share of the mean).

Replicated parameters other than the gate get their gradient from
replicated activations; they take model rank 0's, so every replica
applies the same bits. Whole-matrix parameters are the reference's:
:meth:`TPTransformerLM.init_numpy` draws them in its order, and
:meth:`shard_numpy` / :meth:`gather_numpy` carry them to and from a
rank's shards.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.device.sharding import ProcessMesh
from dmlc_core_tpu_torch.models.transformer import (gelu, layer_norm,
                                                    leaves, local_rows,
                                                    next_token_nll,
                                                    rebuild)
from dmlc_core_tpu_torch.parallel.axis import (all_gather, copy_to_group,
                                               psum_bcast)
from dmlc_core_tpu_torch.parallel.distributed import allreduce_sum_

__all__ = ["TPTransformerConfig", "TPTransformerLM"]

Params = Dict[str, Any]

# leaf specs: how a whole-matrix parameter maps onto a rank's shard
REPLICATED = "replicated"   # whole on every rank, gradient replicated
PARTIAL = "partial"         # whole on every rank, gradient summed
HEADS = "heads"             # qkv: this rank's heads' q, k, v columns


class TPTransformerConfig(NamedTuple):
    vocab: int = 256
    max_seq: int = 128
    embed: int = 64
    heads: int = 4
    layers: int = 2
    mlp_mult: int = 4
    moe_experts: int = 0   # 0 = dense FFN; >0 = top-1 MoE (EP over "model")
    dtype: Any = torch.float32


class TPTransformerLM:
    """Causal LM under DP × TP (× EP) with explicit Megatron layers.

    Build with a mesh that has axes "data" and "model"; ``heads`` (and
    ``moe_experts`` when used) must divide by the "model" size.
    ``step(params, tokens, labels)`` takes the mesh's GLOBAL [B, S] batch
    and this rank's shards and returns (new shards, mean loss)."""

    def __init__(self, config: TPTransformerConfig, mesh: ProcessMesh,
                 learning_rate: float = 0.1):
        if "data" not in mesh.names or "model" not in mesh.names:
            raise ValueError(
                f"need ('data', 'model') mesh axes, got {mesh.names}")
        tp = mesh.size("model")
        if config.heads % tp != 0:
            raise ValueError(
                f"heads={config.heads} must divide by model axis {tp}")
        if config.moe_experts and config.moe_experts % tp != 0:
            raise ValueError(
                f"moe_experts={config.moe_experts} must divide by model "
                f"axis {tp}")
        self.config = config
        self.mesh = mesh
        self.lr = learning_rate
        self.device = mesh.device
        self.tp = tp
        self.rank = mesh.index("model")
        self.group = mesh.group_of("model")

    # ------------------------------------------------------------- params --
    def _ffn_specs(self):
        if self.config.moe_experts:
            # leading expert axis split: each rank owns E / tp experts
            return {"gate": PARTIAL, "w1": 0, "w2": 0}
        return {"w1": 1, "w2": 0}   # w1 column-split, w2 row-split

    def specs(self):
        """The parameter tree's shard specs: REPLICATED, PARTIAL, HEADS,
        or the axis an integer names, split in contiguous blocks."""
        rep = {"scale": REPLICATED, "bias": REPLICATED}
        layer = {"ln1": rep, "qkv": HEADS, "proj": 0, "ln2": rep,
                 "ffn": self._ffn_specs()}
        return {"embed": REPLICATED, "pos": REPLICATED, "ln_f": rep,
                "layers": [layer for _ in range(self.config.layers)]}

    def init_numpy(self, seed: int = 0) -> Dict[str, Any]:
        """The reference's WHOLE parameter tree as numpy float32 arrays:
        the same draws from ``default_rng(seed)`` in the same order."""
        cfg = self.config
        rng = np.random.default_rng(seed)
        D = cfg.embed
        F = cfg.mlp_mult * D

        def dense(*shape, s=0.02):
            return rng.normal(0, s, size=shape).astype(np.float32)

        def ln():
            return {"scale": np.ones((D,), np.float32),
                    "bias": np.zeros((D,), np.float32)}

        def ffn_params():
            if cfg.moe_experts:
                E = cfg.moe_experts
                return {"gate": dense(D, E, s=0.02),
                        "w1": dense(E, D, F, s=D ** -0.5),
                        "w2": dense(E, F, D, s=F ** -0.5)}
            return {"w1": dense(D, F, s=D ** -0.5),
                    "w2": dense(F, D, s=F ** -0.5)}

        params = {"embed": dense(cfg.vocab, D), "pos": dense(cfg.max_seq, D),
                  "ln_f": ln(), "layers": []}
        for _ in range(cfg.layers):
            params["layers"].append({
                "ln1": ln(), "qkv": dense(D, 3 * D, s=D ** -0.5),
                "proj": dense(D, D, s=(2 * D) ** -0.5), "ln2": ln(),
                "ffn": ffn_params()})
        return params

    def _shard_leaf(self, full: np.ndarray, spec) -> np.ndarray:
        if spec in (REPLICATED, PARTIAL):
            return full
        r, tp = self.rank, self.tp
        if spec == HEADS:
            D, H = full.shape[0], self.config.heads
            hl = H // tp
            heads = full.reshape(D, 3, H, full.shape[1] // (3 * H))
            return np.ascontiguousarray(
                heads[:, :, r * hl:(r + 1) * hl]).reshape(D, -1)
        return np.ascontiguousarray(np.split(full, tp, axis=spec)[r])

    def shard_numpy(self, tree) -> Dict[str, Any]:
        """This rank's shards of a whole numpy parameter tree."""
        return rebuild(tree, [self._shard_leaf(np.asarray(a, np.float32), s)
                              for a, s in zip(leaves(tree),
                                              leaves(self.specs()))])

    def from_numpy(self, tree) -> Params:
        """A WHOLE numpy tree as this rank's parameter shards."""
        local = self.shard_numpy(tree)
        return rebuild(local, [torch.tensor(a, device=self.device)
                               for a in leaves(local)])

    def init(self, seed: int = 0) -> Params:
        """This rank's shards of the reference's ``init(seed)``."""
        return self.from_numpy(self.init_numpy(seed))

    def gather_numpy(self, params: Params) -> Dict[str, Any]:
        """The WHOLE parameter tree as numpy, gathered from the "model"
        ranks' shards (a collective: every rank of the axis calls it)."""
        out = []
        for p, spec in zip(leaves(params), leaves(self.specs())):
            t = p.detach()
            if spec == HEADS and self.tp > 1:
                D = t.shape[0]
                hd = self.config.embed // self.config.heads
                t = all_gather(t.reshape(D, 3, -1, hd), 2,
                               self.group).reshape(D, -1)
            elif spec not in (REPLICATED, PARTIAL):
                t = all_gather(t, spec, self.group)
            out.append(t.cpu().numpy())
        return rebuild(params, out)

    # ------------------------------------------------------------ forward --
    def _ffn(self, ffn, h):
        cfg = self.config
        g = self.group
        hc = copy_to_group(h, g)
        if not cfg.moe_experts:
            return psum_bcast(gelu(hc @ ffn["w1"].to(cfg.dtype))
                              @ ffn["w2"].to(cfg.dtype), g)
        # dense top-1 MoE: route each token to its argmax expert; this
        # rank computes its experts' share of the one-hot dispatch
        gates = torch.softmax(hc.float() @ ffn["gate"], dim=-1)  # [b, s, E]
        top = torch.argmax(gates, dim=-1)
        onehot = torch.nn.functional.one_hot(
            top, cfg.moe_experts).to(cfg.dtype)
        # weight tokens by their gate value so routing is differentiable
        disp = onehot * gates.gather(-1, top[..., None]).to(cfg.dtype)
        el = cfg.moe_experts // self.tp
        mine = slice(self.rank * el, (self.rank + 1) * el)
        hidden = torch.einsum("bse,bsd,edf->bsef", onehot[..., mine], hc,
                              ffn["w1"].to(cfg.dtype))
        out = torch.einsum("bsef,efd->bsed", gelu(hidden),
                           ffn["w2"].to(cfg.dtype))
        return psum_bcast(torch.einsum("bsed,bse->bsd", out,
                                       disp[..., mine]), g)

    def _forward(self, params: Params, tokens: torch.Tensor
                 ) -> torch.Tensor:
        cfg = self.config
        hd = cfg.embed // cfg.heads
        hl = cfg.heads // self.tp
        b, s = tokens.shape
        g = self.group
        x = params["embed"][tokens]
        x = (x + params["pos"][None, :s]).to(cfg.dtype)
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                       device=x.device))
        for layer in params["layers"]:
            h = layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
            qkv = (copy_to_group(h, g) @ layer["qkv"].to(cfg.dtype)
                   ).reshape(b, s, 3, hl, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            att = torch.where(causal[None, None], att,
                              att.new_tensor(float("-inf")))
            att = torch.softmax(att.float(), dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd", att.to(cfg.dtype), v)
            x = x + psum_bcast(ctx.reshape(b, s, hl * hd)
                               @ layer["proj"].to(cfg.dtype), g)
            h = layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
            x = x + self._ffn(layer["ffn"], h)
        x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
        return (x @ params["embed"].T.to(cfg.dtype)).float()

    # --------------------------------------------------------------- step --
    def step(self, params: Params, tokens, labels
             ) -> Tuple[Params, torch.Tensor]:
        """One SGD step on next-token loss; returns (params, mean loss)."""
        tok = local_rows(tokens, self.mesh, self.device)
        lab = local_rows(labels, self.mesh, self.device)
        ps = [p.detach().requires_grad_() for p in leaves(params)]
        nll = next_token_nll(self._forward(rebuild(params, ps), tok), lab)
        # this rank's rows' share of the global mean
        loss = nll.sum() / (nll.numel() * self.mesh.size("data"))
        grads = list(torch.autograd.grad(loss, ps))
        specs = leaves(self.specs())
        if self.group is not None:
            # the gate's parts summed; the other replicated gradients
            # taken from model rank 0, so every replica applies one value
            shared = [i for i, s in enumerate(specs)
                      if s in (REPLICATED, PARTIAL)]
            buf = torch.cat([
                (grads[i] if specs[i] == PARTIAL or self.rank == 0
                 else torch.zeros_like(grads[i])).reshape(-1)
                for i in shared])
            allreduce_sum_(buf, group=self.group)
            off = 0
            for i in shared:
                n = grads[i].numel()
                grads[i] = buf[off:off + n].view(grads[i].shape)
                off += n
        buf = torch.cat([g.reshape(-1) for g in grads]
                        + [loss.detach().reshape(1)])
        data = self.mesh.group_of("data")
        if data is not None:
            allreduce_sum_(buf, group=data)
        new, off = [], 0
        for p in ps:
            g = buf[off:off + p.numel()].view(p.shape)
            off += p.numel()
            new.append(p.detach() - self.lr * g)
        return rebuild(params, new), buf[-1]
