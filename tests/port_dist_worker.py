"""One process of a gloo group on the CPU, for
tests/test_torch_port_distributed.py,
tests/test_torch_port_node_distributed.py and
tests/test_torch_port_mesh2d.py:

    python tests/port_dist_worker.py <case> <rank> <world> <dir>

The processes meet in a ``file://`` store under <dir>, run one case of the
port across the group and save what the test compares in
<dir>/<case>_<rank>.pt. The test runs the same functions in its own
process, on a one-process mesh, for the reference. No JAX here: JAX's
draws come in <dir>/given.pt.
"""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from primekg_rgcn_tpu_torch.config import ModelConfig, TrainConfig  # noqa
from primekg_rgcn_tpu_torch.data import sampling  # noqa: E402
from primekg_rgcn_tpu_torch.data.graph import build_rel_graph  # noqa: E402
from primekg_rgcn_tpu_torch.evaluate import sharded_ranking  # noqa: E402
from primekg_rgcn_tpu_torch.models.rgcn import (init_params,  # noqa: E402
                                                param_leaves)
from primekg_rgcn_tpu_torch.ops.cuda import halo  # noqa: E402
from primekg_rgcn_tpu_torch.parallel import edge_shard  # noqa: E402
from primekg_rgcn_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from primekg_rgcn_tpu_torch.parallel import node_shard  # noqa: E402
from primekg_rgcn_tpu_torch.train import checkpoint, sampled  # noqa: E402
from primekg_rgcn_tpu_torch.train.loop import make_optimizer  # noqa: E402

SHARDS = 4


def flat(tree, prefix=""):
    """A nested dict or list of tensors, flattened to {path: tensor}."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().clone()}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}"))
    return out


# -- case "collectives" -------------------------------------------------------


def collective_inputs():
    """Four shards' integer-valued inputs (so every sum is exact) and each
    shard's cotangent for every collective."""
    rng = np.random.default_rng(0)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-8, 8, shape).astype(np.float32))

    xs = [ints(6, 3) for _ in range(SHARDS)]
    scatter_in = [ints(SHARDS * 2, 3) for _ in range(SHARDS)]
    cots = {"psum": [ints(6, 3) for _ in range(SHARDS)],
            "all_gather": [ints(SHARDS, 6, 3) for _ in range(SHARDS)],
            "all_gather_tiled": [ints(SHARDS * 6, 3) for _ in range(SHARDS)],
            "psum_scatter": [ints(2, 3) for _ in range(SHARDS)]}
    return xs, scatter_in, cots


def run_collectives(mesh):
    """Each collective on this process's shards: its output and the
    gradients of this process's inputs under the local loss, the sum over
    its shards of <output, the shard's cotangent>."""
    xs, scatter_in, cots = collective_inputs()
    local = list(mesh.local)
    out = {}

    def leaves(src):
        return [src[s].clone().requires_grad_(True) for s in local]

    for name in ("psum", "all_gather", "all_gather_tiled"):
        ins = leaves(xs)
        y = (pmesh.psum(ins, mesh) if name == "psum"
             else pmesh.all_gather(ins, tiled=name.endswith("tiled"),
                                   mesh=mesh))
        sum((y * cots[name][s]).sum() for s in local).backward()
        out[name] = y.detach()
        out[f"{name}_grad"] = torch.stack([x.grad for x in ins])
    ins = leaves(scatter_in)
    y = pmesh.psum_scatter(ins, mesh)
    sum((y[j] * cots["psum_scatter"][s]).sum()
        for j, s in enumerate(local)).backward()
    out["psum_scatter"] = y.detach()
    out["psum_scatter_grad"] = torch.stack([x.grad for x in ins])
    return out


def case_collectives(rank, world, d):
    mesh = pmesh.make_mesh(SHARDS, "cpu")
    out = run_collectives(mesh)
    out["local"] = torch.tensor(list(mesh.local))
    # all_reduce_: one buffer of two tensors, summed in place.
    a = torch.full((2, 3), float(rank + 1))
    b = torch.arange(4.0) * (rank + 1)
    pmesh.all_reduce_([a, b], mesh)
    out["all_reduce_"] = torch.cat([a.reshape(-1), b])
    pmesh.check_same_across(1.5, "cpu", "a constant")
    try:
        pmesh.check_same_across(float(rank), "cpu", "the rank")
        out["differing_raises"] = torch.tensor(False)
    except RuntimeError:
        out["differing_raises"] = torch.tensor(True)
    for name, shape in (("2x2", (2, 2)), ("1x4", (1, 4)), ("3x2", (3, 2))):
        m = pmesh.make_mesh_2d(*shape, "cpu")
        # The shards of each tp row held here (zero3's fetch replicas),
        # whether a tp row spans processes, and zero3's table slices here.
        sl = pmesh.table_slices(m, by_tp=True)
        route = sampled.FetchRoute.of(m, sl)
        out[f"groups_{name}"] = [
            [s for s, rep in zip(m.local, route.replica) if rep == i]
            for i in range(route.n_rows)]
        out[f"axes_{name}"] = [m.rows_split, sl.held, sl.counted, sl.shared]
    try:
        pmesh.make_mesh(3, "cpu")
        out["odd_shards"] = torch.tensor(False)
    except ValueError:
        out["odd_shards"] = torch.tensor(True)
    return out


# -- case "steps": the data-parallel steps on the port's own generator --------

# (name, layout, mesh shape, sampling mode, table rule)
STEP_RUNS = [
    ("dp", "dp", 4, "uniform", "sgd"),
    ("zero1", "zero1", 4, "block", "sgd"),
    ("zero3", "zero3", 4, "block", "sgd"),
    ("zero3_2x2_adafactor", "zero3", (2, 2), "uniform", "adafactor"),
    ("edge_accum2", "edge", 4, None, "sgd"),
]


def small_graph():
    rng = np.random.default_rng(0)
    n, r, e = 60, 3, 800
    src, dst, rel = (rng.integers(0, n, e), rng.integers(0, n, e),
                     rng.integers(0, r, e))
    graph = build_rel_graph(src, dst, rel, n, r, bucket_pad_multiple=64)
    return graph, np.stack([src, dst, rel], 1).astype(np.int64)


def counting(module, names, counts):
    """Wrap ``module``'s functions ``names`` to add each call to
    ``counts[name]``; returns the originals."""
    saved = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    return saved


# The calls that launch kernel B2 on the card (the dedup gathers' backward
# through the wrapper, the fetch's and table gather's sums through
# ``_sorted_accumulate``, which takes the plain version on the CPU) and B3.
LAUNCHING = {"B2": ("dense_sorted_segment_sum",
                    "dense_sorted_segment_sum_plain"),
             "B3": ("window_rows_fetch",)}


def run_steps(layout, shape, mode, table_opt, *, steps=3, seed=9, batch=64,
              resume_at=None, slim=False):
    """``steps`` updates of one layout from the same parameters, batches
    and generator seed, on a mesh that spans the live group (or one
    process): losses, parameters and optimizer state (whole), the
    generator's final state, the table's local shape and the calls that
    launch B2 and B3 on the card (from the sampling module, all steps).
    ``resume_at`` i (zero3): after step i the step, its parameters and
    optimizer are built anew from the whole table and the gathered
    optimizer state, as a resumed trainer builds them. ``slim``: sample
    over the slim combined CSR in granule-pairs form (block mode's window
    fetches, B3)."""
    graph, edges = small_graph()
    cfg = ModelConfig(num_nodes=60, num_relations=3, embedding_dim=8,
                      hidden_dim=8, dropout=0.3)
    tcfg = TrainConfig(batch_size=batch, lr=1e-2, grad_clip=(
        0.0 if table_opt == "adafactor" else 1.0))
    mesh = (pmesh.make_mesh_2d(*shape, "cpu") if isinstance(shape, tuple)
            else pmesh.make_mesh(shape, "cpu"))
    params = init_params(torch.Generator().manual_seed(0), cfg)
    for p in param_leaves(params):
        p.requires_grad_(True)
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    losses = []
    calls = {n: 0 for names in LAUNCHING.values() for n in names}
    if layout == "edge":
        step = edge_shard.build_sharded_train_step(
            mesh, edge_shard.shard_rel_graph(graph, SHARDS), cfg, tcfg,
            accum_steps=2)
        opt = make_optimizer(tcfg, params)
        for _ in range(steps):
            batch = np.ones((2, 64, 4), np.int64)
            batch[..., :3] = edges[rng.integers(0, len(edges), (2, 64))]
            batch[1, 60:, 3] = 0            # padding rows
            stats = step(params, opt, torch.from_numpy(batch), gen)
            losses.append((stats[0] / stats[2]).item())
        full = params
    else:
        build = getattr(sampled, f"build_sampled_train_step_{layout}")
        kw = dict(table_opt=table_opt) if layout == "zero3" else {}

        csr = (sampling.build_combined_csr(graph, slim=True,
                                           window_pairs=True)
               if slim else graph)

        def fresh_step(params):
            step = build(csr, cfg, tcfg, mesh, fanouts=(5, 3), mode=mode,
                         **kw)
            if layout == "zero3":
                params = step.shard_params(params)
            return step, params, step.init_optimizer(params)

        step, params, opt = fresh_step(params)
        saved = counting(sampling, calls, calls)
        try:
            for i in range(steps):
                pos = torch.from_numpy(edges[rng.integers(0, len(edges),
                                                          batch)])
                losses.append(step(params, opt, pos, gen)[0].item())
                if i + 1 == resume_at:
                    state = opt.state_dict()
                    step, params, opt = fresh_step(
                        fresh(step.full_params(params)))
                    opt.load_state_dict(state)
        finally:
            for name, fn in saved.items():
                setattr(sampling, name, fn)
        full = step.full_params(params) if layout == "zero3" else params
    out = {}
    if layout == "zero3":
        # The optimizer state through the JAX checkpoint's tree and back.
        state = opt.state_dict()
        opt.load_state_dict(checkpoint.optimizer_state_from_jax(
            opt, checkpoint.optimizer_state_to_jax(opt, params, tcfg),
            params))
        out["opt_via_jax"] = flat(opt.state_dict())
        opt.load_state_dict(state)
    return {**out, "losses": torch.tensor(losses, dtype=torch.float64),
            "params": flat(full), "opt": flat(opt.state_dict()),
            "gen": gen.get_state(),
            "table_rows": torch.tensor(
                params["encoder"]["node_emb"].shape[0]),
            "launches": {k: sum(calls[n] for n in names)
                         for k, names in LAUNCHING.items()}}


def case_steps(rank, world, d):
    return {name: run_steps(*run) for name, *run in STEP_RUNS}


# -- case "given": zero3 on JAX's candidates, draws and masks -----------------


class Replay:
    """A sampler ``draw`` that hands out given uniforms in order."""

    def __init__(self, arrays):
        self.arrays = iter(arrays)

    def __call__(self, shape):
        u = next(self.arrays)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"given {tuple(u.shape)}, drawn {shape}")
        return u


def case_given(rank, world, d):
    return run_given(torch.load(Path(d) / "given.pt", weights_only=False))


def run_given(given):
    """The zero3 step on the handed-over parameters and JAX draws, on the
    given mesh (4 flat shards by default) over the live group: the table's
    local rows, and each step's loss, accuracy, whole parameters and
    gathered optimizer state."""
    src, dst, rel = given["edges"].T
    graph = build_rel_graph(src, dst, rel, given["num_nodes"],
                            given["num_relations"], bucket_pad_multiple=64)
    cfg = ModelConfig.from_dict(given["model_config"])
    tcfg = TrainConfig(**given["train_config"])
    shape = given.get("shape", SHARDS)
    mesh = (pmesh.make_mesh_2d(*shape, "cpu") if isinstance(shape, tuple)
            else pmesh.make_mesh(shape, "cpu"))
    step = sampled.build_sampled_train_step_zero3(
        graph, cfg, tcfg, mesh, fanouts=(4, 3),
        mode=given.get("mode", "block"),
        table_opt=given.get("table_opt", "sgd"))
    params = given["params"]
    for p in param_leaves(params):
        p.requires_grad_(True)
    params = step.shard_params(params)
    opt = step.init_optimizer(params)
    out = {"table_rows": torch.tensor(params["encoder"]["node_emb"].shape[0])}
    for i, s in enumerate(given["steps"]):
        loss, acc = step(params, opt, s["pos"], torch.Generator(),
                         cands=s["cands"],
                         draw=[Replay(u) for u in s["uniforms"]],
                         enc_mask=s["masks"])
        out[i] = {"loss": loss.item(), "acc": acc.item(),
                  "params": flat(step.full_params(params)),
                  "opt": flat(opt.state_dict())}
    return out


# -- cases "node" and "node4": the node layout, and zero3 on split rows ------

# (shards, processes) of the exchanges
EXCHANGES = [(4, 2), (8, 2), (8, 4)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# zero3 on meshes whose tp rows are split over the processes, by world
# size: (name, layout, mesh shape, sampling mode, table rule)
SPLIT_RUNS = {2: [("zero3_1x4", "zero3", (1, 4), "block", "sgd")],
              4: [("zero3_2x2", "zero3", (2, 2), "block", "sgd"),
                  ("zero3_2x2_adafactor", "zero3", (2, 2), "uniform",
                   "adafactor")]}


def exchange_inputs(n, dtype):
    """``n`` shards' sends [n, 5, 8] and each recv's cotangent, small
    integers (exact in bf16)."""
    rng = np.random.default_rng(n)

    def ints():
        return torch.from_numpy(rng.integers(-64, 64, (n, 5, 8)).astype(
            np.float32)).to(dtype)

    return [ints() for _ in range(n)], [ints() for _ in range(n)]


def run_exchange(n, dtype, mesh=None):
    """The differentiable exchange of this process's shards over ``mesh``
    (without one: every shard through the plain version): the recvs and
    the sends' gradients under the sum over its shards of <recv,
    cotangent>."""
    sends, cots = exchange_inputs(n, dtype)
    local = range(n) if mesh is None else mesh.local
    leaves = [sends[d].clone().requires_grad_(True) for d in local]
    recvs = (halo.halo_exchange_plain(leaves) if mesh is None
             else halo.HaloExchange.apply(mesh, *leaves))
    sum((r * cots[d]).sum() for r, d in zip(recvs, local)).backward()
    return {"recv": torch.stack([r.detach() for r in recvs]),
            "grad": torch.stack([x.grad for x in leaves])}


def fresh(tree):
    """A copy of a nested dict of tensors, each a leaf that requires grad."""
    if isinstance(tree, dict):
        return {k: fresh(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def run_node(given, *, steps=3, seed=4):
    """The node layout over 4 shards on a mesh that spans the live group
    (or one process), from the handed-over graph, parameters, candidates
    and table: the encode at both ``uniform_caps`` (this process's shards
    and, gathered, the whole), one SGD update on the given candidates,
    ``steps`` adam steps with dropout on the port's generator, the sharded
    top-K, ranks and scores."""
    src, dst, rel = given["edges"].T
    graph = build_rel_graph(src, dst, rel, given["num_nodes"],
                            given["num_relations"], bucket_pad_multiple=64)
    cfg = ModelConfig.from_dict(given["model_config"])
    mesh = pmesh.make_mesh(SHARDS, "cpu")
    local = mesh.local
    out = {}
    with torch.no_grad():
        for u in (False, True):
            psg = node_shard.partition_nodes(graph, SHARDS, uniform_caps=u)
            out[f"encode_{u}"] = node_shard.build_node_sharded_forward(
                mesh, psg, cfg, gather=False)(given["params"])
            out[f"gathered_{u}"] = node_shard.build_node_sharded_forward(
                mesh, psg, cfg)(given["params"])
    psg = node_shard.partition_nodes(graph, SHARDS)

    tcfg = TrainConfig(batch_size=64, lr=1e-2, optimizer="sgd",
                       grad_clip=0.0)
    step = node_shard.build_node_sharded_train_step(mesh, psg, cfg, tcfg)
    params = fresh(given["params"])
    stats = step.update(params, make_optimizer(tcfg, params),
                        given["cands"])
    out["update"] = {"stats": stats, "params": flat(params)}

    dcfg = ModelConfig.from_dict({**given["model_config"], "dropout": 0.3})
    tcfg = TrainConfig(batch_size=64, lr=1e-2)
    step = node_shard.build_node_sharded_train_step(mesh, psg, dcfg, tcfg)
    params = fresh(given["params"])
    opt = make_optimizer(tcfg, params)
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    edges = given["edges"]
    losses = []
    for _ in range(steps):
        batch = np.ones((64, 4), np.int64)
        batch[:, :3] = edges[rng.integers(0, len(edges), 64)]
        batch[60:, 3] = 0                   # padding rows
        stats = step(params, opt, torch.from_numpy(batch), gen)
        losses.append((stats[0] / stats[2]).item())
    out["steps"] = {"losses": torch.tensor(losses, dtype=torch.float64),
                    "params": flat(params), "opt": flat(opt.state_dict()),
                    "gen": gen.get_state()}

    # A graph whose second half of the nodes has only in-shard in-edges:
    # the second process's shards have no halo edge, and yet it joins
    # every exchange, its backward too.
    keep = (dst < 48) | (src // 24 == dst // 24)
    inner = node_shard.partition_nodes(build_rel_graph(
        src[keep], dst[keep], rel[keep], given["num_nodes"],
        given["num_relations"], bucket_pad_multiple=64), SHARDS)
    out["no_halo_shards"] = [
        d for d in range(SHARDS) if int(inner.rowptr_halo[d, :, -1].sum()) == 0]
    tcfg = TrainConfig(batch_size=64, lr=1e-2, optimizer="sgd",
                       grad_clip=0.0)
    step = node_shard.build_node_sharded_train_step(mesh, inner, cfg, tcfg)
    params = fresh(given["params"])
    stats = step.update(params, make_optimizer(tcfg, params),
                        given["cands"])
    out["no_halo"] = {"stats": stats, "params": flat(params)}

    t = given["topk"]
    emb_dm = t["emb"][local.start:local.stop]
    topk = sharded_ranking.build_sharded_topk(
        mesh, emb_dm, t["rel"], t["num_nodes"], t["k"])(t["heads"],
                                                         t["rels"])
    rank, score = sharded_ranking.build_sharded_eval_from_sharded(
        mesh, emb_dm, t["rel"], t["num_nodes"])
    full = t["emb"].reshape(-1, t["emb"].shape[-1])[:t["num_nodes"]]
    out["topk"] = {
        "scores": topk[0], "ids": topk[1],
        "rank": rank(t["heads"], t["rels"], t["tails"]),
        "score": score(t["heads"], t["tails"], t["rels"]),
        "ranker": sharded_ranking.build_sharded_ranker(mesh, full, t["rel"])(
            t["heads"], t["rels"], t["tails"])}
    return out


def _node_cases(world, d):
    out = {}
    for n, w in EXCHANGES:
        if w == world:
            mesh = pmesh.make_mesh(n, "cpu")
            for name, dtype in DTYPES.items():
                out[f"exchange_{n}_{name}"] = run_exchange(n, dtype, mesh)
    for name, *spec in SPLIT_RUNS[world]:
        out[name] = run_steps(*spec)
    return out


def case_node(rank, world, d):
    given = torch.load(Path(d) / "given.pt", weights_only=False)
    return {**_node_cases(world, d), **run_node(given)}


def case_node4(rank, world, d):
    return _node_cases(world, d)


# -- case "jax_resume": zero3 resumed from a JAX checkpoint ------------------


def case_jax_resume(rank, world, d):
    """A 4-shard zero3 trainer over the live group (or one process)
    resumed from the JAX checkpoint that <dir>/given.pt names, then two
    steps on its own generator: losses, the full parameters, the gathered
    optimizer state, and this process's resumed table moments."""
    given = torch.load(Path(d) / "given.pt", weights_only=False)
    edges = given["edges"]
    cfg = ModelConfig.from_dict(given["model_config"])
    graph = build_rel_graph(*edges.T, cfg.num_nodes, cfg.num_relations,
                            bucket_pad_multiple=64)
    t = sampled.SampledTrainer(
        cfg, TrainConfig.from_dict(given["train_config"]), graph, graph,
        edges, edges[:60], Path(d) / f"out_{world}_{rank}", fanouts=(4, 3),
        mode="uniform", n_devices=SHARDS, zero3=True, device="cpu")
    t.resume(given["stem"])
    table = t.optimizer.table
    out = {"table_rows": torch.tensor(t.params["encoder"]["node_emb"]
                                      .shape[0]),
           "resumed_mu": table.state[table.param_groups[0]["params"][0]][
               "exp_avg"].clone()}
    gen = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(5)
    losses = []
    for _ in range(2):
        pos = torch.from_numpy(edges[rng.integers(0, len(edges), 24)])
        losses.append(t.step_fn(t.params, t.optimizer, pos, gen)[0].item())
    out.update(losses=np.array(losses),
               params=flat(t.step_fn.full_params(t.params)),
               opt=flat(t.optimizer.state_dict()))
    return out


# -- case "mesh2d": zero3 on 2-D meshes whose processes hold parts of two
# tp rows -------------------------------------------------------------------

# The mesh by world size: (3, 2) over 2 processes gives each 3 shards (a
# whole row and half of the next), (2, 3) over 3 gives each 2 (process 1
# holds the end of row 0 and the start of row 1).
MESH2D = {2: (3, 2), 3: (2, 3)}
MESH2D_BATCH = 60
# (name, sampling mode, table rule); block mode over the slim CSR
MESH2D_RUNS = [("sgd", "block", "sgd"), ("adafactor", "uniform", "adafactor")]


def case_mesh2d(rank, world, d):
    """Both table rules for 3 steps on this world's mesh, and again with
    the step rebuilt after step 2 from the gathered state; the zero3 step
    on the JAX draws in <dir>/given.pt; the mesh's slices here."""
    shape = MESH2D[world]
    out = {}
    for name, mode, rule in MESH2D_RUNS:
        kw = dict(batch=MESH2D_BATCH, slim=mode == "block")
        out[name] = run_steps("zero3", shape, mode, rule, **kw)
        out[f"{name}_resumed"] = run_steps("zero3", shape, mode, rule,
                                           resume_at=2, **kw)
    out["given"] = run_given(torch.load(Path(d) / "given.pt",
                                        weights_only=False))
    mesh = pmesh.make_mesh_2d(*shape, "cpu")
    sl = pmesh.table_slices(mesh, by_tp=True)
    out["mesh"] = {"local": list(mesh.local), "rows_split": mesh.rows_split,
                   "held": sl.held, "counted": sl.counted}
    return out


CASES = {"collectives": case_collectives, "steps": case_steps,
         "given": case_given, "node": case_node, "node4": case_node4,
         "jax_resume": case_jax_resume, "mesh2d": case_mesh2d}


def main():
    case, rank, world, d = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                            sys.argv[4])
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            world_size=world, rank=rank)
    try:
        out = CASES[case](rank, world, d)
        torch.save(out, Path(d) / f"{case}_{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
