"""DLRM-DCNv2: the MLPerf Training recommender (Naumov et al. 2019, "Deep
Learning Recommendation Model for Personalization and Recommendation
Systems", arXiv:1906.00091; Wang et al. 2020, "DCN V2", arXiv:2008.13535;
MLCommons ``training/recommendation_v2/torchrec_dlrm``).

Margin of a row with dense values ``x`` and, for each table ``t``, a bag
of ids (sum pooling; each id has value 1):

    e0   = ReLU(L_B(... ReLU(L_1(x))))               the bottom MLP
    e_t  = Σ_{i ∈ bag(t)} E_t[i]                     t = 1 .. T
    x0   = [e0, e1, ..., e_T]
    x_{l+1} = x0 ⊙ (W_l (V_l x_l) + b_l) + x_l      the low-rank cross net
    y    = L_K(ReLU(L_{K-1}(... ReLU(L_1(x_L)))))    the top MLP

and the loss is the shared ``objective_loss`` (logistic for the model),
divided by the batch's weight like every learner's.

**Input.** The field-aware CSR batch ``DeviceRowBlockIter(uri,
batch_rows, layout="csr")`` yields from a libfm or ``.crec`` file: fields
``0 .. num_dense - 1`` are the dense values at columns ``0 .. num_dense -
1`` (taken with ``ops.sparse.csr_to_dense``, which drops every other
column as out of range; under ``DCT_CSR_TO_DENSE=pallas`` that is the
hand-written kernel), and fields ``num_dense + t`` hold table ``t``'s
ids as columns ``num_dense + offset_t + row``. Padding nonzeros (row ==
rows per shard) and the dense values fall out of the bags.

**Tables.** All tables are one ``[Σ N_t, D]`` leaf, ``table``, as a
table-batched embedding holds them, so a column less ``num_dense`` is the
row. The nonzeros are sorted by bag (row × T + table: one sort of int64
keys) and the bags' bounds found by a binary search; reading how many
ids the bags hold is the step's wait on the card (``torch.unique`` waits
once more to size its output). The distinct rows the ids name are
gathered once (:class:`_Rows`), and one ``embedding_bag(mode="sum")``
pools them by each id's place among them: autograd sums the gradient of
a row looked up many times, and the table's gradient is a coalesced
sparse tensor over the distinct rows, never a dense ``[Σ N_t, D]`` one.

**Update.** Adagrad at ``learning_rate`` with ``eps`` and the initial
accumulator ``initial_accumulator``, on the gradient of the batch mean
(``_dp.py``'s ``denom``): elementwise for the dense leaves, as
``torch.optim.Adagrad`` does; row-wise for the table, as TorchRec's fused
``EXACT_ROW_WISE_ADAGRAD`` does: each distinct row's accumulator grows by
the mean of its squared gradient, and the rows and their accumulators
are updated in place. Rows not looked up are not touched. The dense
leaves are updated in place too (the multi-tensor step
``torch.optim.Adagrad`` takes), so ``step()`` hands back the parameters
it was given. The accumulators are leaves of the parameters
(``acc_<leaf>``), so they travel through ``step()`` and the checkpoint
utilities; the step differentiates only the weights.

**Precision.** float32 throughout; on a card the learner turns TF32 off
for matmuls and cuDNN (``torch.backends``), process-wide.

**Mesh.** None: the deployment shards the tables over the ranks and
exchanges the pooled bags (all-to-all), which the port does not have, and
the mesh step all-reduces dense gradients of every leaf. A mesh is
refused.

**Telemetry** (while ``telemetry.enabled()``): ``dlrm_embed_us`` (the
lookup and pooling), ``dlrm_cross_us`` (the cross network's forward) and
``dlrm_embed_update_us`` (the row-wise update), stream time between
markers as ``_dp.py``'s phases, inside ``record_function`` ranges
``dlrm_embed``, ``dlrm_cross`` and ``dlrm_embed_update`` while a
profiler records; ``dlrm_lookup_ids`` and ``dlrm_unique_rows`` once a
step, from counts the host already holds.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.base import resolve_device
from dmlc_core_tpu_torch.device.device_iter import (to_device_batch,
                                                    unpack_tree)
from dmlc_core_tpu_torch.models._dp import DataParallelModel
from dmlc_core_tpu_torch.models.linear import objective_loss
from dmlc_core_tpu_torch.ops.sparse import csr_to_dense

__all__ = ["DLRMLearner", "dlrm_params_type"]

ACC = "acc_"


@functools.lru_cache(maxsize=None)
def dlrm_params_type(bottom_layers: int, cross_layers: int,
                     top_layers: int):
    """The NamedTuple of a DLRM-DCNv2's leaves: ``bottom<i>_w``/``_b``,
    ``cross<l>_v``/``_w``/``_b``, ``top<i>_w``/``_b``, ``table``, then an
    Adagrad accumulator ``acc_<leaf>`` for each (the table's one a row).
    One class per depth."""
    names = ([f"bottom{i}_{k}" for i in range(bottom_layers)
              for k in "wb"]
             + [f"cross{i}_{k}" for i in range(cross_layers)
                for k in "vwb"]
             + [f"top{i}_{k}" for i in range(top_layers) for k in "wb"]
             + ["table"])
    return collections.namedtuple("DLRMParams",
                                  names + [ACC + n for n in names])


class _Rows(torch.autograd.Function):
    """``table``'s rows ``index`` (sorted and distinct), whose gradient
    is a coalesced sparse tensor over those rows alone."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.shape = table.shape
        return table.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        index, = ctx.saved_tensors
        return torch.sparse_coo_tensor(
            index[None], grad, ctx.shape, check_invariants=False,
            is_coalesced=True), None


class DLRMLearner(DataParallelModel):
    """DLRM-DCNv2 on one device.

    Usage::

        learner = DLRMLearner(table_rows=[...], multi_hot_sizes=[...])
        params = learner.init(seed=0)
        for batch in DeviceRowBlockIter(uri, 8192, layout="csr"):
            params, loss = learner.step(params, batch)

    ``table_rows``: the rows held of each table; ``multi_hot_sizes``: ids
    a row draws from each (the data's bags are what the step pools;
    these say what a row holds). ``bottom``'s last width is the embedding
    dimension ``embed_dim``; ``top``'s last is 1, the margin."""

    _SPANS = {
        "embed": ("dlrm_embed",
                  lambda: telemetry.histogram("dlrm_embed_us")),
        "cross": ("dlrm_cross",
                  lambda: telemetry.histogram("dlrm_cross_us")),
        "update": ("dlrm_embed_update",
                   lambda: telemetry.histogram("dlrm_embed_update_us")),
    }

    def __init__(self, table_rows: Sequence[int],
                 multi_hot_sizes: Sequence[int], embed_dim: int = 128,
                 bottom: Sequence[int] = (512, 256, 128),
                 cross_layers: int = 3, cross_rank: int = 512,
                 top: Sequence[int] = (1024, 1024, 512, 256, 1),
                 num_dense: int = 13, learning_rate: float = 0.005,
                 eps: float = 1e-8, initial_accumulator: float = 0.0,
                 objective: str = "logistic", mesh=None, device=None):
        if mesh is not None:
            raise ValueError(
                "DLRMLearner runs on one device: its tables would be "
                "sharded over the mesh's ranks and their bags exchanged "
                "(all-to-all), which the port does not have, and the mesh "
                "step all-reduces dense gradients of every leaf; pass "
                "mesh=None")
        if len(multi_hot_sizes) != len(table_rows):
            raise ValueError(f"{len(table_rows)} tables but "
                             f"{len(multi_hot_sizes)} multi-hot sizes")
        if bottom[-1] != embed_dim or top[-1] != 1:
            raise ValueError(f"the bottom MLP must end at embed_dim "
                             f"{embed_dim} and the top MLP at 1, got "
                             f"{tuple(bottom)} and {tuple(top)}")
        self.table_rows = tuple(int(n) for n in table_rows)
        self.multi_hot_sizes = tuple(int(h) for h in multi_hot_sizes)
        self.embed_dim = embed_dim
        self.bottom = tuple(bottom)
        self.cross_layers = cross_layers
        self.cross_rank = cross_rank
        self.top = tuple(top)
        self.num_dense = num_dense
        self.learning_rate = learning_rate
        self.eps = eps
        self.initial_accumulator = initial_accumulator
        self.objective = objective
        self.device = resolve_device(device)
        self.params_type = dlrm_params_type(len(self.bottom), cross_layers,
                                            len(self.top))
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    @property
    def width(self) -> int:
        """The cross network's width: the bottom's output and T bags."""
        return self.embed_dim * (1 + len(self.table_rows))

    def init(self, seed: int = 0):
        """Weights drawn on the learner's device from a generator seeded
        with ``seed``, as TorchRec initializes them: each MLP layer
        ``U(±1/sqrt(fan_in))`` for weight and bias (``nn.Linear``), the
        cross network's ``V`` and ``W`` Xavier-normal and ``b`` zero, each
        table ``U(±1/sqrt(N_t))`` with ``N_t`` its rows; every
        accumulator at ``initial_accumulator``."""
        g = torch.Generator(device=self.device).manual_seed(seed)

        def uniform(shape, bound):
            return torch.empty(shape, device=self.device).uniform_(
                -bound, bound, generator=g)

        def xavier(rows, cols):
            return torch.empty((rows, cols), device=self.device).normal_(
                0.0, math.sqrt(2.0 / (rows + cols)), generator=g)

        leaves = []
        for fan_in, out in zip((self.num_dense,) + self.bottom[:-1],
                               self.bottom):
            b = 1.0 / math.sqrt(fan_in)
            leaves += [uniform((out, fan_in), b), uniform((out,), b)]
        W = self.width
        for _ in range(self.cross_layers):
            leaves += [xavier(self.cross_rank, W),
                       xavier(W, self.cross_rank),
                       torch.zeros(W, device=self.device)]
        for fan_in, out in zip((W,) + self.top[:-1], self.top):
            b = 1.0 / math.sqrt(fan_in)
            leaves += [uniform((out, fan_in), b), uniform((out,), b)]
        table = torch.empty((sum(self.table_rows), self.embed_dim),
                            device=self.device)
        for part, n in zip(table.split(self.table_rows), self.table_rows):
            b = 1.0 / math.sqrt(n)
            part.uniform_(-b, b, generator=g)
        leaves.append(table)
        acc = [torch.full(p.shape[:1] if p is table else p.shape,
                          float(self.initial_accumulator),
                          device=self.device) for p in leaves]
        return self.params_type(*leaves, *acc)

    def _differentiated(self, params) -> Tuple[bool, ...]:
        return tuple(not f.startswith(ACC) for f in params._fields)

    def _timed(self) -> bool:
        """Whether this is a step with telemetry on."""
        return self._timer is not None and self._timer.on

    # -- forward -------------------------------------------------------
    def _pool(self, table: torch.Tensor, row: torch.Tensor,
              col: torch.Tensor, field: torch.Tensor, num_rows: int
              ) -> Tuple[torch.Tensor, int]:
        """([num_rows, T * D] bags, ids looked up) of one shard."""
        T = len(self.table_rows)
        t = field.long() - self.num_dense
        # the dense values and the padding nonzeros (row == num_rows) sort
        # past the last bag
        key = torch.where(t >= 0, row.long() * T + t, num_rows * T)
        key, order = torch.sort(key, stable=True)
        bounds = torch.searchsorted(
            key, torch.arange(num_rows * T + 1, device=key.device))
        n = int(bounds[-1])  # the step's wait on the card: ids looked up
        ids = col.index_select(0, order[:n]).long() - self.num_dense
        rows, place = torch.unique(ids, return_inverse=True)
        bags = F.embedding_bag(place, _Rows.apply(table, rows), bounds[:-1],
                               mode="sum")
        if self._timed():
            telemetry.histogram("dlrm_unique_rows").observe(rows.numel())
        return bags.view(num_rows, T * self.embed_dim), n

    def _margin(self, p, shard, num_rows: int) -> torch.Tensor:
        if "field" not in shard:
            raise ValueError(
                "DLRMLearner reads field-aware CSR batches (libfm text or "
                ".crec converted from it, layout='csr'): the batch has no "
                "field plane")
        h = csr_to_dense(shard["row"], shard["col"], shard["val"], num_rows,
                         self.num_dense)
        for i in range(len(self.bottom)):
            h = F.relu(F.linear(h, getattr(p, f"bottom{i}_w"),
                                getattr(p, f"bottom{i}_b")))
        with self._span("embed"):
            bags, n = self._pool(p.table, shard["row"], shard["col"],
                                 shard["field"], num_rows)
        if self._timed():
            telemetry.histogram("dlrm_lookup_ids").observe(n)
        x0 = torch.cat([h, bags], dim=1)
        with self._span("cross"):
            x = x0
            for i in range(self.cross_layers):
                x = x0 * F.linear(F.linear(x, getattr(p, f"cross{i}_v")),
                                  getattr(p, f"cross{i}_w"),
                                  getattr(p, f"cross{i}_b")) + x
        for i in range(len(self.top)):
            x = F.linear(x, getattr(p, f"top{i}_w"), getattr(p, f"top{i}_b"))
            if i + 1 < len(self.top):
                x = F.relu(x)
        return x[:, 0]

    def _shard_loss(self, params, shard, rows_per_shard):
        return objective_loss(self._margin(params, shard, rows_per_shard),
                              shard, rows_per_shard, self.objective)

    # -- update --------------------------------------------------------
    def _apply(self, params, grads, denom):
        lr, eps = self.learning_rate, self.eps
        dense = [f for f in params._fields
                 if not f.startswith(ACC) and f != "table"]
        w = [getattr(params, f) for f in dense]
        acc = [getattr(params, ACC + f) for f in dense]
        # torch.optim.Adagrad's multi-tensor step, in place
        g = torch._foreach_div([getattr(grads, f) for f in dense], denom)
        torch._foreach_addcmul_(acc, g, g)
        std = torch._foreach_sqrt(acc)
        torch._foreach_add_(std, eps)
        torch._foreach_addcdiv_(w, g, std, value=-lr)
        with self._span("update"):
            # coalesced (:class:`_Rows`): each distinct row looked up once
            rows = grads.table.indices()[0]
            gv = grads.table.values() / denom
            a = params.acc_table.index_select(0, rows) + \
                gv.pow(2).mean(dim=1)
            params.acc_table.index_copy_(0, rows, a)
            params.table.index_add_(
                0, rows, gv * (-lr / (a.sqrt() + eps))[:, None])
        return params

    @torch.no_grad()
    def predict(self, params, batch) -> torch.Tensor:
        """Margins [D, R] (apply sigmoid for probabilities) of a device
        or host CSR batch."""
        R = batch.rows_per_shard
        tree = unpack_tree(to_device_batch(batch,
                                           params.table.device).tree())
        return torch.stack([
            self._margin(params, {"row": row, "col": col, "val": val,
                                  "field": field}, R)
            for row, col, val, field in zip(tree["row"], tree["col"],
                                            tree["val"], tree["field"])])
