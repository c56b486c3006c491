"""One rank of the LM lane's test worlds (port only: torch, no JAX).

    python tests/torch_lm_worker.py <mode> <inputs.npz> <out_dir>

Started by :func:`tests.torch_world_worker.run_world` under the launcher
env protocol; every rank runs every case of its mode and writes
``<out_dir>/rank<r>.npz``. The test files compute the JAX package's
side of each case and compare. Modes:

- ``ring``: the axis collectives' values and gradients, ``ring_allreduce``,
  and ``sequence_parallel_attention`` (contiguous, causal or not, and
  zigzag) with its input gradients, on axes of 2 and 4 ranks;
- ``transformer``: ``TransformerLM`` steps on a ("data", "seq") mesh;
- ``tp``: ``TPTransformerLM`` steps on a ("data", "model") mesh, dense and
  MoE;
- ``pipeline``: ``pipeline_apply`` forward, with a data axis, and the
  per-stage gradients.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def ring_mode(inp, out):
    from dmlc_core_tpu_torch.device.sharding import process_mesh
    from dmlc_core_tpu_torch.parallel import axis
    from dmlc_core_tpu_torch.parallel.ring import (
        ring_allreduce, sequence_parallel_attention)
    world = process_mesh((("r", 4),), device="cpu")
    me = world.index("r")
    pair = process_mesh((("r", 2),), device="cpu")  # ranks {0,1}, {2,3}
    groups = {2: pair.group_of("r"), 4: world.group_of("r")}
    for p, g in groups.items():
        r = axis.axis_index(g)
        x = _t(inp[f"x{p}"][r], grad=True)
        w = inp[f"w{p}"]
        # ppermute one step forward: rank r's value lands on r + 1
        y = axis.ppermute(x, [(i, (i + 1) % p) for i in range(p)], g)
        (y * _t(w[r])).sum().backward()
        out[f"ppermute_y{p}"], out[f"ppermute_g{p}"] = y.detach(), x.grad
        for name, fn in (("psum", axis.psum), ("psum_bcast",
                                                axis.psum_bcast)):
            x = _t(inp[f"x{p}"][r], grad=True)
            y = fn(x, g)
            # psum: a rank's own weights; psum_bcast: a replicated loss
            (y * _t(w[r] if name == "psum" else w[0])).sum().backward()
            out[f"{name}_y{p}"], out[f"{name}_g{p}"] = y.detach(), x.grad
        x = _t(inp[f"x{p}"][0], grad=True)  # replicated input
        (axis.copy_to_group(x, g) * _t(w[r])).sum().backward()
        out[f"copy_g{p}"] = x.grad
        out[f"allreduce{p}"] = ring_allreduce(_t(inp[f"big{p}"][r]), g)
        for name in ("dense", "causal", "zigzag"):
            q, k, v = (_t(inp[f"{name}{p}_{c}"], grad=True) for c in "qkv")
            o = sequence_parallel_attention(
                q, k, v, g, causal=name != "dense",
                layout="zigzag" if name == "zigzag" else "contiguous")
            (o * _t(inp[f"{name}{p}_w"])).sum().backward()
            out[f"{name}{p}_o"] = o.detach()
            for c, t in zip("qkv", (q, k, v)):
                out[f"{name}{p}_d{c}"] = t.grad
    out["rank"] = torch.tensor(me)


def _params_out(out, prefix, params):
    from dmlc_core_tpu_torch.models.transformer import leaves
    for i, leaf in enumerate(leaves(params)):
        out[f"{prefix}{i}"] = leaf.detach()


def transformer_mode(inp, out):
    from dmlc_core_tpu_torch.device.sharding import process_mesh
    from dmlc_core_tpu_torch.models.transformer import (TransformerConfig,
                                                        TransformerLM)
    mesh = process_mesh((("data", 2), ("seq", 2)), device="cpu")
    cfg = TransformerConfig(**{k: int(v) for k, v in
                               inp["cfg"].item().items()})
    model = TransformerLM(cfg, mesh, learning_rate=float(inp["lr"]))
    params = model.init(seed=int(inp["seed"]))
    losses = []
    for x, y in zip(inp["tokens"], inp["labels"]):
        params, loss = model.step(params, x, y)
        losses.append(float(loss))
    out["losses"] = torch.tensor(losses, dtype=torch.float64)
    _params_out(out, "p", params)


def tp_mode(inp, out):
    from dmlc_core_tpu_torch.device.sharding import process_mesh
    from dmlc_core_tpu_torch.models.convert import lm_params_to_numpy
    from dmlc_core_tpu_torch.models.tp_transformer import (
        TPTransformerConfig, TPTransformerLM)
    from dmlc_core_tpu_torch.models.transformer import leaves
    mesh = process_mesh((("data", 2), ("model", 2)), device="cpu")
    for name in ("dense", "moe"):
        cfg = TPTransformerConfig(**{k: int(v) for k, v in
                                     inp[f"{name}_cfg"].item().items()})
        model = TPTransformerLM(cfg, mesh, learning_rate=float(inp["lr"]))
        params = model.init(seed=int(inp["seed"]))
        out[f"{name}_qkv_shard0"] = params["layers"][0]["qkv"]
        losses = []
        for _ in range(int(inp["steps"])):
            params, loss = model.step(params, inp["tokens"], inp["labels"])
            losses.append(float(loss))
        out[f"{name}_losses"] = torch.tensor(losses, dtype=torch.float64)
        full = lm_params_to_numpy(params, model)
        for i, leaf in enumerate(leaves(full)):
            out[f"{name}_p{i}"] = torch.from_numpy(leaf)


def stage_fn(w, x):
    """One homogeneous MLP stage, the reference test's: [mb, D] -> [mb, D]."""
    return torch.tanh(x @ w["a"]) @ w["b"] + x


def pipeline_mode(inp, out):
    from dmlc_core_tpu_torch.device.sharding import process_mesh
    from dmlc_core_tpu_torch.parallel.pipeline_parallel import pipeline_apply
    pipe4 = process_mesh((("pipe", 4),), device="cpu")
    dp = process_mesh((("data", 2), ("pipe", 2)), device="cpu")
    s = pipe4.index("pipe")
    # forward over 4 stages
    w = {k: _t(inp[f"fwd_{k}"][s]) for k in "ab"}
    out["fwd"] = pipeline_apply(stage_fn, w, _t(inp["fwd_mb"]),
                                pipe4.group_of("pipe"))
    # DP x PP: data shard d's microbatches through 2 stages
    s2, d = dp.index("pipe"), dp.index("data")
    w = {k: _t(inp[f"dp_{k}"][s2]) for k in "ab"}
    out["dp"] = pipeline_apply(stage_fn, w, _t(inp["dp_mb"][d]),
                               dp.group_of("pipe"))
    # backward over 4 stages: this stage's gradient of the mean loss
    w = {k: _t(inp[f"bwd_{k}"][s], grad=True) for k in "ab"}
    y = pipeline_apply(stage_fn, w, _t(inp["bwd_mb"]),
                       pipe4.group_of("pipe"))
    loss = ((y - _t(inp["bwd_target"])) ** 2).mean()
    loss.backward()
    out["bwd_loss"] = loss.detach()
    for k in "ab":
        out[f"bwd_g{k}"] = w[k].grad


MODES = {"ring": ring_mode, "transformer": transformer_mode, "tp": tp_mode,
         "pipeline": pipeline_mode}


def main(mode, inputs, out_dir):
    from dmlc_core_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    distributed.init_from_env(device="cpu")
    try:
        inp = dict(np.load(inputs, allow_pickle=True))
        out = {}
        MODES[mode](inp, out)
        rank = distributed.rank()
    finally:
        distributed.shutdown()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: v.numpy() for k, v in out.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
