"""Count the collectives of one mesh train step (or, with ``--decode``, of
one decode step of the serving engine), and say where each redistribution
comes from, on the CPU.

    python3 kubetorch_tpu_torch/tools/mesh_comms.py --mesh '{"data": 2, "fsdp": 2, "tensor": 2}'
    python3 kubetorch_tpu_torch/tools/mesh_comms.py --decode --mesh '{"data": 2, "context": 4}'
    python3 kubetorch_tpu_torch/tools/mesh_comms.py --model moe --mesh '{"expert": 4, "fsdp": 2}'
    python3 kubetorch_tpu_torch/tools/mesh_comms.py --model moe --decode --mesh '{"expert": 2, "tensor": 2}'

Spawns one gloo rank per device of ``--mesh`` (processes of its own, on
the CPU, ``torch.distributed`` given its address, world size and rank),
builds the mesh with ``parallel.build_mesh``, lays tiny fp32 Llama (or
``--model vit``, or ``--model moe``: tiny Mixtral by ``MOE_RULES``
through ``moe_loss``) out by the rule table and runs ``--steps`` steps of
``make_train_step(mesh=, rules=)``. For each step after the first (whose
counts equal the later ones; it also fills DTensor's sharding cache) rank
0 prints one JSON line: the collectives ``CommDebugMode`` counted, by
kind, and every redistribution, grouped by where it came from (the
DTensor op whose inputs it reshaped, or the port's function that asked
for it: ``linear``, ``constrain_hidden``, ``constrain_tree``,
``on_local_heads``, ...), its placements before and after, and the
tensor's shape. A transition that turns a ``Shard`` into ``Replicate()``
is an all-gather; those are the places to hold against what GSPMD would
do. The counts are the program's, so a CPU run gives them; no time is
measured.

``--decode``: tiny fp32 Llama laid out by ``LLAMA_RULES`` (``--model
moe``: tiny Mixtral by ``MOE_RULES``), served by
``GenerationEngine(mesh=)`` with ``--batch`` slots (each holding a
request) and a grid of ``--seq`` rows; after the admissions and ``--steps``
decode steps, one more decode step of the whole grid
(``serve.engine._decode_block``, one token a slot: the device work of an
engine step, without the host's step agreement, whose two all-reduces run
on a gloo group of their own) is counted the same way.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import socket
import sys

# the checkout this file sits in, for the spawned ranks too
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _where() -> str:
    """The innermost frame of the port (outside this tool) on the stack."""
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename
        if "kubetorch_tpu_torch" in path and "tools" not in path:
            return frame.f_code.co_name
        frame = frame.f_back
    return "autograd (a backward)"


def _instrument(log: collections.Counter):
    """Wrap DTensor's redistribution entry points to log each call as
    (where, before -> after, shape)."""
    from torch.distributed.tensor import _api, _dispatch, _redistribute

    current_op = []
    orig_args = _dispatch.OpDispatcher.redistribute_local_args

    def redistribute_local_args(op_info, suggested, *args, **kwargs):
        # op_info.schema is None on DTensor's cached fast path
        current_op.append(str(suggested.op))
        try:
            return orig_args(op_info, suggested, *args, **kwargs)
        finally:
            current_op.pop()

    _dispatch.OpDispatcher.redistribute_local_args = staticmethod(
        redistribute_local_args)
    orig = _redistribute.redistribute_local_tensor

    def redistribute_local_tensor(local, current_spec, target_spec, *a, **kw):
        where = current_op[-1] if current_op else _where()
        log[(where, f"{list(current_spec.placements)} -> "
                    f"{list(target_spec.placements)}",
             str(tuple(current_spec.shape)))] += 1
        return orig(local, current_spec, target_spec, *a, **kw)

    for mod in (_redistribute, _dispatch, _api):
        mod.redistribute_local_tensor = redistribute_local_tensor


def _rank(rank: int, world: int, port: int, args) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    torch.set_num_threads(1)
    from kubetorch_tpu_torch.parallel import (LLAMA_RULES, MOE_RULES, VIT_RULES,
                                              build_mesh)
    from kubetorch_tpu_torch.serving import distributed
    from kubetorch_tpu_torch.train import adam, init_train_state, make_train_step

    distributed.init_process_group(device="cpu")
    try:
        mesh = build_mesh(json.loads(args.mesh), device="cpu")
        if args.decode:
            return _decode_rank(rank, mesh, args)
        g = torch.Generator().manual_seed(1)
        if args.model == "vit":
            from kubetorch_tpu_torch.models import vit as V
            cfg = V.VitConfig.tiny(dtype=torch.float32, remat=False)
            params, rules = V.vit_init(0, cfg, device="cpu"), VIT_RULES
            batch = {"tokens": torch.randn(args.batch, cfg.image_size,
                                           cfg.image_size, cfg.channels,
                                           generator=g),
                     "targets": torch.randint(0, cfg.n_classes, (args.batch,),
                                              generator=g)}

            def loss(p, x, y):
                return V.vit_loss(p, x, y, cfg)
        elif args.model == "moe":
            from kubetorch_tpu_torch.models import moe as M
            cfg = M.MoeConfig.tiny(dtype=torch.float32, remat=False,
                                   attn_impl=args.attn_impl)
            params, rules = M.moe_init(cfg, device="cpu"), MOE_RULES
            tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                                   generator=g)
            batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}

            def loss(p, t, y):
                return M.moe_loss(p, t, y, cfg)
        else:
            from kubetorch_tpu_torch.models import llama as L
            cfg = L.LlamaConfig.tiny(dtype=torch.float32, remat=False,
                                     attn_impl=args.attn_impl)
            params, rules = L.llama_init(cfg, device="cpu"), LLAMA_RULES
            tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                                   generator=g)
            batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}

            def loss(p, t, y):
                if args.chunk:
                    return L.llama_loss_chunked(p, t, y, cfg, chunk=args.chunk)
                return L.llama_loss(p, t, y, cfg)
        opt = adam(1e-2)
        step = make_train_step(loss, opt, mesh=mesh, rules=rules,
                               accum_steps=args.accum,
                               overlap_grads=args.overlap)
        state = step.shard_state(init_train_state(params, opt))
        log: collections.Counter = collections.Counter()
        _instrument(log)
        for i in range(args.steps):
            log.clear()
            with CommDebugMode() as comm:
                state, m = step(state, batch)
            if rank == 0 and i > 0:
                counts = {str(k).split("'")[1] if "'" in str(k) else str(k): v
                          for k, v in comm.get_comm_counts().items()}
                rows = [dict(where=w, transition=t, shape=s, count=n)
                        for (w, t, s), n in sorted(log.items())]
                print(json.dumps(dict(
                    mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                    model=args.model, step=i, loss=float(m["loss"]),
                    collectives=counts, redistributions=rows)), flush=True)
    finally:
        distributed.destroy()


def _decode_rank(rank: int, mesh, args) -> None:
    import numpy as np
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from kubetorch_tpu_torch.models import llama as L
    from kubetorch_tpu_torch.models import moe as M
    from kubetorch_tpu_torch.parallel import LLAMA_RULES, MOE_RULES
    from kubetorch_tpu_torch.parallel.mesh_context import use_mesh
    from kubetorch_tpu_torch.parallel.sharding import shard_pytree
    from kubetorch_tpu_torch.serve import GenerationEngine
    from kubetorch_tpu_torch.serve import engine as E

    if args.model == "moe":
        cfg = M.MoeConfig.tiny(dtype=torch.float32, remat=False,
                               attn_impl=args.attn_impl)
        params = shard_pytree(M.moe_init(cfg, device="cpu"), MOE_RULES, mesh)
    else:
        cfg = L.LlamaConfig.tiny(dtype=torch.float32, remat=False,
                                 attn_impl=args.attn_impl)
        params = shard_pytree(L.llama_init(cfg, device="cpu"), LLAMA_RULES, mesh)
    eng = GenerationEngine(params, cfg, slots=args.batch, max_len=args.seq,
                           prefill_buckets=(8,), device="cpu", mesh=mesh)
    for i in range(args.batch):
        eng.submit([1 + i, 2, 3], max_new_tokens=args.seq - 8)
    for _ in range(args.steps):
        eng.step()
    log: collections.Counter = collections.Counter()
    _instrument(log)
    n = eng.slots
    with torch.no_grad(), use_mesh(mesh), CommDebugMode() as comm:
        E._decode_block(eng.params, eng._cache,
                        torch.from_numpy(eng._pos), torch.from_numpy(eng._tok),
                        cfg, eng._freqs, 1, np.zeros(n, np.float32), None,
                        np.ones(n, np.float32), [None] * n, grid=eng._grid)
    if rank == 0:
        counts = {str(k).split("'")[1] if "'" in str(k) else str(k): v
                  for k, v in comm.get_comm_counts().items()}
        rows = [dict(where=w, transition=t, shape=s, count=c)
                for (w, t, s), c in sorted(log.items())]
        print(json.dumps(dict(
            mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), model=args.model,
            decode_step=dict(slots=n, grid_rows=args.seq,
                             layers=cfg.n_layers),
            grid=[repr(p) for p in eng._cache.k.placements],
            collectives=counts, redistributions=rows)), flush=True)


def main(argv=None) -> None:
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default='{"data": 2, "fsdp": 2, "tensor": 2}')
    ap.add_argument("--model", choices=("llama", "vit", "moe"), default="llama")
    ap.add_argument("--attn-impl", default="auto")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=0,
                    help="chunked CE of this chunk (0: the full-vocab loss)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--decode", action="store_true",
                    help="one decode step of the serving engine instead")
    args = ap.parse_args(argv)
    world = 1
    for v in json.loads(args.mesh).values():
        world *= int(v)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(world, port, args), nprocs=world)


if __name__ == "__main__":
    main()
