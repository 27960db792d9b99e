"""Multi-process drill of the port: the zero3 sampled step across real
process boundaries (``torch.distributed``: gloo on the CPU or on a shared
card, NCCL on cards of their own), held against the same step on a
one-process 4-shard mesh. The counterpart of ``scripts/multihost_drill.py``.

The frontier-row psum_scatter, its all-gather transpose, the loss sums,
the clip's global norm and the slice-local adam update all cross a process
boundary: each of the P processes holds the table slices of its own 4/P
shards. Each process saves its loss and its slices as
``drill_p<pid>_<mh|solo>.npz`` (the slices keyed by tp index). Then every
process builds a checkpoint payload from the multi-process state (the
table and the optimizer's slices gathered) and process 0 alone writes it,
loads it back and checks the table against the slices.

Run every process (``tests/test_torch_port_distributed.py`` does, or by
hand); they meet at ``$DRILL_COORD`` (host:port, default
``localhost:23456``):

    python scripts/port_multihost_drill.py <process_id> <num_processes> \\
        <outdir> [--device cpu|cuda]

The one-process reference:

    python scripts/port_multihost_drill.py solo 1 <outdir> [--device cpu|cuda]
"""

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("role", help="the process id, or 'solo' for the "
                                "one-process reference")
    p.add_argument("num_processes", type=int)
    p.add_argument("outdir")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    solo = args.role == "solo"
    pid = 0 if solo else int(args.role)
    sys.path.insert(0, str(REPO))

    import numpy as np
    import torch

    from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig
    from primekg_rgcn_tpu_torch.data.graph import build_rel_graph
    from primekg_rgcn_tpu_torch.device import resolve_device
    from primekg_rgcn_tpu_torch.models.rgcn import init_params, param_leaves
    from primekg_rgcn_tpu_torch.parallel.mesh import make_mesh
    from primekg_rgcn_tpu_torch.train import checkpoint
    from primekg_rgcn_tpu_torch.train.multichip import (
        maybe_initialize_distributed)
    from primekg_rgcn_tpu_torch.train.sampled import (
        build_sampled_train_step_zero3)
    from primekg_rgcn_tpu_torch.train.torch_interop import (
        state_dict_from_params)

    if not solo and not maybe_initialize_distributed(
            os.environ.get("DRILL_COORD", "localhost:23456"),
            args.num_processes, pid, device=args.device):
        raise RuntimeError("the drill's processes did not meet")
    dev = resolve_device(args.device)

    rng = np.random.default_rng(7)
    n, r, e = 80, 10, 600
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    rel = rng.integers(0, r, e)
    graph = build_rel_graph(src, dst, rel, n, r, bucket_pad_multiple=64)
    cfg = ModelConfig(num_nodes=n, num_relations=r, embedding_dim=8,
                      hidden_dim=8, dropout=0.3)
    tcfg = TrainConfig(batch_size=32, lr=1e-2)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    edges = torch.from_numpy(np.stack([src, dst, rel], 1).astype(np.int64))

    mesh = make_mesh(4, dev)
    step = build_sampled_train_step_zero3(graph, cfg, tcfg, mesh,
                                          fanouts=(4, 3))
    pp = step.shard_params(params)
    opt = step.init_optimizer(pp)
    gen = torch.Generator(dev).manual_seed(3)
    batches = np.random.default_rng(3)
    for _ in range(3):
        bi = torch.from_numpy(batches.integers(0, e, 32))
        loss, _ = step(pp, opt, edges[bi].to(dev), gen)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"loss {loss}")

    emb_dm = pp["encoder"]["node_emb"]
    if emb_dm.shape[0] != 4 // mesh.world:
        raise RuntimeError(f"process {pid} holds {emb_dm.shape[0]} slices")
    rows = {str(t): emb_dm[j].detach().cpu().numpy()
            for j, t in enumerate(step.owners)}
    tag = "solo" if solo else "mh"
    out = Path(args.outdir)
    np.savez(out / f"drill_p{pid}_{tag}.npz", loss=loss, **rows)

    # Every process builds the payload (it gathers the sharded leaves);
    # process 0 alone writes it.
    ck = out / f"ck_{tag}.pt"
    checkpoint.save(ck, {
        "model_state_dict": state_dict_from_params(step.full_params(pp)),
        "optimizer_state_dict": opt.state_dict(), "epoch": 1,
        "best_val_loss": loss, "best_val_acc": 0.0, "history": {},
        "model_config": cfg.to_dict(), "train_config": tcfg.to_dict()})
    if pid == 0:
        back = checkpoint.load(ck)["params"]["encoder"]["node_emb"].numpy()
        n_loc = emb_dm.shape[1]
        for t, val in rows.items():
            lo = int(t) * n_loc
            got = back[lo:lo + n_loc]
            np.testing.assert_array_equal(got, val[:len(got)])
    print(f"[{'solo' if solo else f'p{pid}'}] loss={loss:.6f} "
          f"slices={sorted(rows, key=int)} ckpt=ok", flush=True)


if __name__ == "__main__":
    main()
