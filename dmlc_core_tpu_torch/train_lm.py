"""Language-model training CLI: byte-level next-token prediction over the
LM lane's parallelism, the port of ``examples/train_lm.py``.

    # DP x SP — ring attention (sequence sharded over "seq")
    python -m dmlc_core_tpu_torch.train_lm corpus.txt --mesh data=2,seq=4

    # DP x TP (+MoE) — Megatron splits + top-1 experts
    python -m dmlc_core_tpu_torch.train_lm corpus.txt --model tp \\
        --mesh data=2,model=4

    # on the CPU, one process
    python -m dmlc_core_tpu_torch.train_lm corpus.txt --seq 256 \\
        --steps 3 --embed 32 --layers 1 --device cpu

The flags, their defaults, the windows (:func:`byte_windows`, bit for bit
the reference's), the printed ``step N: loss X.XXXX`` and ``done: ...``
lines, the run identity and the checkpoints are the reference's, plus
``--device`` (default ``cuda``; without CUDA it raises) and
``--backend`` (``gloo`` lets the ranks of a world share one card).

A mesh is a grid of ranks, one device each (``device.sharding.
ProcessMesh``): a world started from the launcher env protocol holds
``npart × prod(mesh)`` ranks, each consecutive block of ``prod(mesh)`` is
one mesh and stands where the reference has a host (``part = rank //
prod(mesh)``); every part steps on its own rows of each step's global
windows, and the parts' parameters are meaned with ``allreduce_tree``
after every step, as the reference's hosts do. ``--mesh data=1,seq=1``
over N ranks is the reference's elastic-mesh configuration. Under
``tracker.submit`` a worker checks in with the tracker; the
``StepWatchdog`` loop turns a dead peer into a structured abort (the
abort record and exit 41) instead of a hung collective.

In a world ``--checkpoint`` writes a two-phase job checkpoint (one part
per mesh, written by its first rank, then rank 0's commit marker); one
process writes one plain checkpoint. Tensor-parallel shards are gathered
to whole matrices before a save, so each package restores the other's LM
checkpoints.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from dmlc_core_tpu_torch.base import resolve_device

__all__ = ["parse_mesh", "load_corpus", "byte_windows", "main"]


def parse_mesh(spec: str):
    """"data=2,seq=4" -> (("data", 2), ("seq", 4))."""
    out = []
    for part in spec.split(","):
        name, _, n = part.partition("=")
        out.append((name.strip(), int(n)))
    return tuple(out)


def load_corpus(path: str, seq: int) -> np.ndarray:
    """The whole corpus, memory-mapped (each rank reads only the window
    bytes it samples)."""
    if os.path.getsize(path) < seq + 1:
        raise SystemExit(f"corpus has {os.path.getsize(path)} bytes; "
                         f"need at least seq+1={seq + 1}")
    return np.memmap(path, np.uint8, mode="r")


def byte_windows(data: np.ndarray, seq: int, batch: int, seed: int,
                 step: int, part: int = 0, npart: int = 1) -> np.ndarray:
    """[batch, seq+1] int32 windows for THIS part at ``step``.

    The GLOBAL stream of npart*batch windows per step is seeded by
    (seed, step) alone and sampled over the whole corpus, so a resumed run
    continues the identical stream from any step and every part slices
    its contiguous rows out of the same global batch (the reference's
    sampler, bit for bit)."""
    rng = np.random.default_rng([seed, step])
    starts = rng.integers(0, data.size - seq, size=npart * batch)
    mine = starts[part * batch:(part + 1) * batch]
    return np.stack([np.asarray(data[s:s + seq + 1])
                     for s in mine]).astype(np.int32)


def _args(argv):
    ap = argparse.ArgumentParser(
        description="train a byte-level LM on the port's LM lane")
    ap.add_argument("corpus", help="any file; bytes are the tokens")
    ap.add_argument("--model", default="lm", choices=("lm", "tp"),
                    help="lm: DP x SP ring attention; tp: DP x TP + MoE")
    ap.add_argument("--mesh", default="data=1,seq=1",
                    help='axis spec, e.g. "data=2,seq=4" (lm) or '
                         '"data=2,model=4" (tp)')
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=0,
                    help="rows per step (0 = one per data-axis slice)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--embed", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--experts", type=int, default=0,
                    help="tp only: MoE experts (0 = 2 per model slice)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="",
                    help="URI to write params + step each --ckpt-every "
                         "steps (any stream scheme: file/s3/hdfs/azure); "
                         "a world writes a two-phase job checkpoint")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", default="",
                    help="checkpoint URI (same base as --checkpoint) to "
                         "restore before training")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without "
                         "CUDA)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="collective backend of a multi-process world "
                         "(default: nccl on CUDA, gloo on the CPU; gloo "
                         "lets ranks share one card)")
    args = ap.parse_args(argv)
    if args.checkpoint and args.ckpt_every <= 0:
        raise SystemExit("--ckpt-every must be positive")
    return args


def main(argv=None) -> int:
    """CLI entry; returns the process exit code."""
    from dmlc_core_tpu_torch.parallel import distributed
    args = _args(argv)
    device = resolve_device(args.device)
    owns_world = not torch.distributed.is_initialized()
    distributed.init_from_env(device=device, backend=args.backend)
    try:
        return _train(args, device)
    finally:
        if owns_world:
            distributed.shutdown()


def _model(args, mesh, names):
    if args.model == "lm":
        from dmlc_core_tpu_torch.models.transformer import (
            TransformerConfig, TransformerLM)
        cfg = TransformerConfig(vocab=256, max_seq=args.seq,
                                embed=args.embed, heads=args.heads,
                                layers=args.layers)
        return TransformerLM(cfg, mesh, learning_rate=args.lr)
    from dmlc_core_tpu_torch.models.tp_transformer import (
        TPTransformerConfig, TPTransformerLM)
    n_model = names.get("model", 1)
    # heads shard over the model axis: round up to the next multiple, and
    # say so; the rounded count must still divide --embed
    heads = -(-args.heads // n_model) * n_model
    if heads != args.heads:
        print(f"note: --heads {args.heads} rounded up to {heads} "
              f"(must divide by model={n_model})")
    if args.embed % heads:
        raise SystemExit(
            f"--embed {args.embed} must divide by heads={heads} "
            f"(after rounding to the model axis); pick --embed as a "
            f"multiple of {heads}")
    cfg = TPTransformerConfig(
        vocab=256, max_seq=args.seq, embed=args.embed, heads=heads,
        layers=args.layers, moe_experts=args.experts or 2 * n_model)
    return TPTransformerLM(cfg, mesh, learning_rate=args.lr)


def _train(args, device) -> int:
    from dmlc_core_tpu_torch.device.sharding import (process_mesh,
                                                     process_part)
    from dmlc_core_tpu_torch.models.convert import (lm_params_from_numpy,
                                                    lm_params_to_numpy)
    from dmlc_core_tpu_torch.parallel import (STEP_ABORT_EXIT, StepWatchdog,
                                              distributed, structured_abort)
    from dmlc_core_tpu_torch.tracker.wire import TrackerAbortedError
    from dmlc_core_tpu_torch.utils.checkpoint import (
        commit_job_checkpoint, restore_checkpoint, restore_job_checkpoint,
        save_checkpoint, save_job_checkpoint)

    # elastic-mesh check-in: under tracker.submit the worker joins the
    # rendezvous, which opens the heartbeat channel (env-gated); the
    # abort broadcast and the step watchdog below turn a SIGKILLed peer
    # into a structured between-steps abort
    client = assign = None
    if os.environ.get("DMLC_TRACKER_URI"):
        from dmlc_core_tpu_torch.tracker.client import RendezvousClient
        from dmlc_core_tpu_torch.tracker.wire import env_int
        client = RendezvousClient(os.environ["DMLC_TRACKER_URI"],
                                  env_int("DMLC_TRACKER_PORT", 9091))
        assign = client.start(heartbeat=None)

    axes = parse_mesh(args.mesh)
    mesh = process_mesh(axes, device=device)
    names = dict(axes)
    n_data = names.get("data", 1)
    batch = args.batch or n_data
    if batch % n_data:
        raise SystemExit(f"--batch {batch} must divide by data={n_data}")
    n_seq = names.get("seq", 1)
    if args.seq % n_seq:
        raise SystemExit(f"--seq {args.seq} must divide by seq={n_seq}")
    model = _model(args, mesh, names)
    params = model.init(seed=args.seed)

    mesh_world = distributed.world_size() > 1
    part, npart = (mesh.part, mesh.npart) if mesh_world else process_part()
    # a mesh's first rank writes its part; the others hold the same
    # parameters (after the gather of tensor-parallel shards)
    writer = all(c == 0 for c in mesh.coords)
    suffix = f".part{part}of{npart}" if npart > 1 else ""
    # the data stream's identity: a resume under a different one would
    # silently continue on different windows
    identity = {"model": args.model, "mesh": args.mesh,
                "seq": str(args.seq), "batch": str(batch),
                "seed": str(args.seed), "part": f"{part}/{npart}"}
    start = 0
    if args.resume:
        template = model.init_numpy(seed=args.seed)
        if mesh_world:
            # only a COMMITTED step is resumable; no marker (a relaunch
            # before the first commit) is a fresh start
            got = restore_job_checkpoint(args.resume, part, npart,
                                         like=template)
            where = f"committed job checkpoint {args.resume}"
        else:
            got = restore_checkpoint(args.resume + suffix, like=template)
            where = args.resume + suffix
        if got is None:
            print("no committed job checkpoint yet; starting fresh",
                  flush=True)
        else:
            full, start, extra = got
            mismatch = {k: (extra.get(k), v) for k, v in identity.items()
                        if extra.get(k) != v}
            if mismatch:
                raise SystemExit(
                    f"checkpoint was written under a different run "
                    f"identity (stored vs now): {mismatch}")
            params = lm_params_from_numpy(full, model)
            print(f"resumed from {where} at step {start}", flush=True)

    def save_ckpt(at_step):
        full = lm_params_to_numpy(params, model)  # gathers TP shards
        if not mesh_world:
            save_checkpoint(args.checkpoint + suffix, full, step=at_step,
                            extra=identity)
            return
        if writer:
            save_job_checkpoint(args.checkpoint, full, at_step, part,
                                npart, extra=identity)
        # every part is PUBLISHED before rank 0 names the set in the
        # commit marker; a rank that dies first leaves the step torn
        # and therefore unresumable, by design
        distributed.barrier(f"ckpt-{at_step}")
        if distributed.rank() == 0:
            commit_job_checkpoint(args.checkpoint, at_step, npart)

    data = load_corpus(args.corpus, args.seq)
    rank = assign.rank if assign is not None else distributed.rank()
    cross = mesh_world and npart > 1
    wd = step = None
    first = last = None
    try:
        if mesh_world or os.environ.get("DMLC_TRACKER_URI"):
            wd = StepWatchdog(rank=rank).start()
        for step in range(start, args.steps):
            if wd is not None:
                wd.step_begin(step)
            w = byte_windows(data, args.seq, batch, args.seed, step, part,
                             npart)
            params, loss = model.step(params, w[:, :-1], w[:, 1:])
            if cross:
                # a part's step + the cross-part parameter mean == the
                # global-batch update (equal per-part batches); the
                # rank-ordered reduction keeps every replica bit-identical
                params = distributed.allreduce_tree(params, "mean",
                                                    group=mesh.part_group)
                loss = distributed.allreduce(
                    np.asarray(float(loss), np.float32), "mean",
                    group=mesh.part_group)
            if wd is not None:
                wd.step_end()
            last = float(loss)
            if first is None:
                first = last
            print(f"step {step}: loss {last:.4f}", flush=True)
            if args.checkpoint and (step + 1) % args.ckpt_every == 0:
                save_ckpt(step + 1)
        if (args.checkpoint and last is not None
                and args.steps % args.ckpt_every != 0):  # not saved yet
            save_ckpt(args.steps)
    except (TrackerAbortedError, torch.distributed.DistError) as e:
        # a peer died: the tracker's abort (between steps), or in a world
        # the error a collective raises when the dead peer's connection
        # closes — drain, leave the postmortem record naming the error,
        # and exit with the structured code the supervisor maps to
        # "relaunch the world from the last commit". Any other error (an
        # out-of-memory, a bad flag, a bug) is no peer's fault and
        # propagates: relaunching would only repeat it
        if wd is not None:
            wd.drain()
        at = f" at step {step}" if step is not None else ""
        structured_abort(f"train_lm{at}: {type(e).__name__}: {e}",
                         rank=rank)
        return STEP_ABORT_EXIT
    finally:
        if wd is not None:
            wd.stop()
    if client is not None:
        client.shutdown(rank)
    if last is None:
        print(f"nothing to do: resume step {start} >= --steps {args.steps}")
        return 0
    print(f"done: loss {first:.4f} -> {last:.4f} over steps "
          f"{start}..{args.steps - 1} (mesh {args.mesh}, seq {args.seq}, "
          f"part {part}/{npart})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
