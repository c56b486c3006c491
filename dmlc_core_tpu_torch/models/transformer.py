"""Sequence-parallel causal transformer LM — the DP × SP model.

Port of ``dmlc_core_tpu/models/transformer.py``. The reference's step
runs under ``shard_map`` over a ("data", "seq") mesh; here each rank of a
:class:`~dmlc_core_tpu_torch.device.sharding.ProcessMesh` runs it on its
own shard:

- batch rows split over "data", sequence positions over "seq", attention
  computed by the ring (``parallel/ring.py``) over the "seq" group, so a
  sequence of length S costs O(S / seq ranks) activation memory a rank;
- parameters replicated; every rank takes the gradient of its LOCAL loss
  sum with autograd (the ring's backward sends K/V cotangents back
  around the ring), then one all-reduce over the whole mesh sums the
  gradients, the loss sum and the token count, and every rank applies
  ``p - lr * g / total`` to the same bits, so the replicas stay
  bit-identical.

Parameters are the reference's nested dict (``embed``, ``pos``,
``ln_f``, ``layers``), and :meth:`TransformerLM.init` makes the
reference's numpy draws in its order, so both packages start from the
same bits.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from dmlc_core_tpu_torch.device.sharding import ProcessMesh
from dmlc_core_tpu_torch.parallel.distributed import allreduce_sum_
from dmlc_core_tpu_torch.parallel.ring import ring_attention
from dmlc_core_tpu_torch.utils.checkpoint import _leaves_with_keys, _rebuild

__all__ = ["TransformerConfig", "TransformerLM"]

Params = Dict[str, Any]


class TransformerConfig(NamedTuple):
    vocab: int = 256
    max_seq: int = 128
    embed: int = 64
    heads: int = 4
    layers: int = 2
    mlp_mult: int = 4
    dtype: Any = torch.float32


def layer_norm(x, scale, bias, eps=1e-5):
    """The reference's layer norm: biased variance, ``rsqrt(v + eps)``."""
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * scale + bias


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh form."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def next_token_nll(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Per-token negative log-likelihood of ``labels`` under ``logits``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0]


def local_rows(x, mesh: ProcessMesh, device, seq_axis=None
               ) -> torch.Tensor:
    """This rank's block of the mesh's global [B, S] tokens: its rows by
    its "data" coordinate and, with ``seq_axis``, its positions by its
    coordinate on that axis. ``x`` is integer numpy or a tensor; the
    block comes back as int64 on ``device``."""
    t = torch.as_tensor(x).to(device=device, dtype=torch.int64)
    B, S = t.shape
    nd = mesh.size("data")
    ns = mesh.size(seq_axis) if seq_axis else 1
    if B % nd or S % ns:
        raise ValueError(f"batch {tuple(t.shape)} must divide by the mesh "
                         f"(data={nd}, {seq_axis}={ns})")
    b, s = B // nd, S // ns
    d = mesh.index("data")
    q = mesh.index(seq_axis) if seq_axis else 0
    return t[d * b:(d + 1) * b, q * s:(q + 1) * s]


def leaves(params: Params):
    """The parameter tree's leaves in the reference's flattening order."""
    return [leaf for _, leaf in _leaves_with_keys(params)]


def rebuild(params: Params, new) -> Params:
    """``params``'s tree with its leaves taken from ``new`` in order."""
    return _rebuild(params, iter(new))


def _dense(rng, m, n, s):
    return rng.normal(0, s, size=(m, n)).astype(np.float32)


class TransformerLM:
    """Causal LM with ring-attention sequence parallelism.

    Build with a mesh that has axes "data" and "seq" (a 1 × 1 mesh runs
    with no world); ``step(params, tokens, labels)`` takes the mesh's
    GLOBAL [B, S] batch, the same on each of its ranks, and returns
    (new_params, global mean loss), the same on every rank."""

    def __init__(self, config: TransformerConfig, mesh: ProcessMesh,
                 learning_rate: float = 0.1):
        if "data" not in mesh.names or "seq" not in mesh.names:
            raise ValueError(
                f"need ('data', 'seq') mesh axes, got {mesh.names}")
        self.config = config
        self.mesh = mesh
        self.lr = learning_rate
        self.device = mesh.device

    # ------------------------------------------------------------- params --
    def init_numpy(self, seed: int = 0) -> Dict[str, Any]:
        """The reference's parameter tree as numpy float32 arrays: the
        same draws from ``default_rng(seed)`` in the same order."""
        cfg = self.config
        rng = np.random.default_rng(seed)
        D = cfg.embed

        def ln():
            return {"scale": np.ones((D,), np.float32),
                    "bias": np.zeros((D,), np.float32)}

        params = {"embed": _dense(rng, cfg.vocab, D, 0.02),
                  "pos": _dense(rng, cfg.max_seq, D, 0.02),
                  "ln_f": ln(), "layers": []}
        for _ in range(cfg.layers):
            params["layers"].append({
                "ln1": ln(),
                "qkv": _dense(rng, D, 3 * D, D ** -0.5),
                "proj": _dense(rng, D, D, (2 * D) ** -0.5),
                "ln2": ln(),
                "w1": _dense(rng, D, cfg.mlp_mult * D, D ** -0.5),
                "w2": _dense(rng, cfg.mlp_mult * D, D,
                             (cfg.mlp_mult * D) ** -0.5),
            })
        return params

    def from_numpy(self, tree) -> Params:
        """A numpy tree as this rank's parameters (replicated: all of it)."""
        return rebuild(tree, [torch.tensor(np.asarray(a, np.float32),
                                           device=self.device)
                              for a in leaves(tree)])

    def init(self, seed: int = 0) -> Params:
        """Fresh parameters on this rank's device, bit-equal to the
        reference's ``init(seed)``."""
        return self.from_numpy(self.init_numpy(seed))

    def gather_numpy(self, params: Params) -> Dict[str, Any]:
        """The parameter tree as numpy (every rank holds all of it)."""
        return rebuild(params, [p.detach().cpu().numpy()
                                for p in leaves(params)])

    # ------------------------------------------------------------ forward --
    def _forward_local(self, params: Params, tokens: torch.Tensor
                       ) -> torch.Tensor:
        """This rank's forward: tokens [b, s_loc] -> logits [b, s_loc, V].
        Attention is the "seq" ring; the rest is position-local."""
        cfg = self.config
        H, D = cfg.heads, cfg.embed
        hd = D // H
        b, s_loc = tokens.shape
        me = self.mesh.index("seq")
        seq = self.mesh.group_of("seq")

        x = params["embed"][tokens]
        pos = params["pos"][me * s_loc:(me + 1) * s_loc]
        x = (x + pos[None]).to(cfg.dtype)
        for layer in params["layers"]:
            h = layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
            qkv = (h @ layer["qkv"].to(cfg.dtype)).reshape(b, s_loc, 3, H,
                                                           hd)
            att = ring_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                 seq, causal=True)
            x = x + att.reshape(b, s_loc, D) @ layer["proj"].to(cfg.dtype)
            h = layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
            h = gelu(h @ layer["w1"].to(cfg.dtype))
            x = x + h @ layer["w2"].to(cfg.dtype)
        x = layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
        return (x @ params["embed"].T.to(cfg.dtype)).float()

    # --------------------------------------------------------------- step --
    def step(self, params: Params, tokens, labels):
        """One SGD step on next-token loss; returns (params, mean loss)."""
        tok = local_rows(tokens, self.mesh, self.device, "seq")
        lab = local_rows(labels, self.mesh, self.device, "seq")
        ps = [p.detach().requires_grad_() for p in leaves(params)]
        nll = next_token_nll(self._forward_local(rebuild(params, ps), tok),
                             lab)
        loss_sum = nll.sum()
        grads = torch.autograd.grad(loss_sum, ps)
        # one reduction over BOTH axes: the gradients, the loss sum and
        # the token count, so the update below is the same on every rank
        buf = torch.cat([g.reshape(-1) for g in grads] + [
            loss_sum.detach().reshape(1),
            torch.full((1,), float(nll.numel()), device=self.device)])
        if self.mesh.group is not None:
            allreduce_sum_(buf, group=self.mesh.group)
        total = buf[-1]
        new, off = [], 0
        for p in ps:
            g = buf[off:off + p.numel()].view(p.shape)
            off += p.numel()
            new.append(p.detach() - self.lr * g / total)
        return rebuild(params, new), buf[-2] / total
