"""Checkpoints of the port: reference-layout ``.pt`` files, and the JAX
package's own layout.

The trainer writes the reference's layout (``model_state_dict`` as PyG's
RGCNConv keeps it, ``optimizer_state_dict``, ``epoch``, ``best_val_loss``,
``best_val_acc``, ``history``, ``args`` as an ``argparse.Namespace``) plus
``model_config`` and ``train_config`` as plain dicts and the random
generators' states as tensors. The pickle holds nothing of this package,
so the JAX package's ``checkpoint.load`` reads the file as it stands.

A checkpoint of the JAX package is two files beside a stem:
``stem.msgpack``, the flax encoding of ``TrainState(params, opt_state,
step)`` (read and written by ``train/flax_msgpack.py``, without flax), and
``stem.json``, its epoch, best values, history, ``rng_key``,
``model_config`` and ``train_config``. :func:`load` takes either layout
(the JAX one by its stem, ``stem.msgpack`` or ``stem.json``);
:func:`save_jax` writes the JAX one. :func:`optimizer_state_from_jax` and
:func:`optimizer_state_to_jax` map the optax state of every JAX trainer
onto the port's optimizers and back, leaf by leaf by path: the optax
chain's adam moments (wherever the chain puts them) onto
``torch.optim.Adam``/``AdamW``, the sharded table's device-major state
onto ``SplitOptimizer.table``, the factored table statistics, and the
layer-1 history cache of ``CachedOptimizer``.

Across processes (``--distributed``) every process calls ``save`` (or
``save_jax``), after building its payload (which gathers the sharded
leaves), and process 0 alone writes, as the JAX ``save`` does;
``AsyncSaver`` runs on process 0 alone.
"""

from __future__ import annotations

import copy
import json
import os
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from primekg_rgcn_tpu_torch.parallel.mesh import process_group_size
from primekg_rgcn_tpu_torch.train import flax_msgpack
from primekg_rgcn_tpu_torch.train.torch_interop import reference_from_blob

# Entries of a trainer checkpoint that ``load`` passes through when present.
TRAINER_KEYS = ("history", "optimizer_state_dict", "train_config",
                "rng_state", "device_rng_state")


def is_torch_checkpoint(path: Path) -> bool:
    """True for a torch pickle (by suffix, or by zip / legacy pickle magic)."""
    if path.suffix in (".pt", ".pth"):
        return path.is_file()
    if not path.is_file():
        return False
    with open(path, "rb") as f:
        magic = f.read(2)
    return magic in (b"PK", b"\x80\x02")


def save(path, payload: Dict[str, Any]) -> None:
    """Write ``payload`` with ``torch.save``, atomically: to a temporary
    file beside ``path``, then ``os.replace``, so that a run killed while
    saving leaves the previous file whole. A no-op on every process of a
    group but process 0."""
    if process_group_size()[1] != 0:
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _host_snapshot(obj):
    """A copy of ``obj`` that later training cannot change: every tensor
    copied to the host now (a CUDA tensor's copy waits for the device), and
    every container and other value copied."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _host_snapshot(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_snapshot(v) for v in obj)
    return copy.deepcopy(obj)


class AsyncSaver:
    """Non-blocking :func:`save` on one background thread.

    ``save_async`` copies the payload to the host at once, so the file holds
    the state of the moment of the call, and leaves ``torch.save`` and the
    disk write to the thread: the training loop goes on meanwhile. Writes
    run in call order; a save to a path that is still being written waits
    for that write first. ``wait_for_saves`` drains them all and raises the
    first writer error.
    """

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Dict[Path, Future] = {}

    def save_async(self, path, payload: Dict[str, Any]) -> Optional[Future]:
        """Queue the write (None, and nothing done, on a process of a
        group other than process 0)."""
        if process_group_size()[1] != 0:
            return None
        path = Path(path)
        earlier = self._pending.pop(path, None)
        if earlier is not None:
            earlier.result()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="ckpt-save")
        fut = self._pool.submit(save, path, _host_snapshot(payload))
        self._pending[path] = fut
        return fut

    def wait_for_saves(self) -> None:
        """Block until every pending write is on disk; stop the thread."""
        pending, self._pending = self._pending, {}
        pool, self._pool = self._pool, None
        try:
            for fut in pending.values():
                fut.result()
        finally:
            if pool is not None:
                pool.shutdown(wait=True)


def jax_stem(path) -> Path:
    """The stem of a JAX checkpoint given as its stem, ``stem.msgpack`` or
    ``stem.json`` (the JAX ``load``'s three forms)."""
    path = Path(path)
    return path.with_suffix("") if path.suffix in (".msgpack", ".json") \
        else path


def _jax_files(path) -> Tuple[Path, Path]:
    """(``.json``, ``.msgpack``) of a JAX checkpoint; raises
    ``FileNotFoundError`` naming whichever is missing."""
    stem = jax_stem(path)
    files = stem.with_suffix(".json"), stem.with_suffix(".msgpack")
    missing = [str(f) for f in files if not f.is_file()]
    if missing:
        raise FileNotFoundError(
            f"{path} is neither a reference-layout .pt checkpoint nor a "
            f"whole JAX checkpoint (stem.msgpack + stem.json): missing "
            f"{', '.join(missing)}")
    return files


def _read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _jax_model_config(meta: Dict[str, Any]) -> Dict[str, Any]:
    cfg = dict(meta["model_config"])
    cfg.setdefault("compute_dtype", "float32")
    return cfg


def stored_model_config(path) -> Dict[str, Any]:
    """The ``model_config`` dict that :func:`load` would return, read from
    a JAX checkpoint's ``.json`` alone (a ``.pt`` is loaded whole)."""
    path = Path(path)
    if is_torch_checkpoint(path):
        return load(path)["model_config"]
    return _jax_model_config(_read_json(_jax_files(path)[0]))


def _read_file(path: Path) -> bytearray:
    """The file's bytes in one bytearray, read in place (no second copy)."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        view, at = memoryview(buf), 0
        while at < len(buf):
            n = f.readinto(view[at:])
            if not n:
                raise OSError(f"{path} ended early")
            at += n
    return buf


def load(path, *, device="cpu") -> Dict[str, Any]:
    """Read a reference-layout ``.pt`` checkpoint or a JAX one.

    Returns {"params", "model_config" (dict), "epoch", "best_val_loss",
    "best_val_acc"} with the parameters on ``device``.

    A ``.pt`` (tested first, by suffix or magic, as the JAX package tests
    it) adds the entries of ``TRAINER_KEYS`` that the file holds (on the
    CPU); its ``model_config`` comes from the parameter shapes, with the
    ``compute_dtype`` of the file's own ``model_config`` when it has one
    (else float32), so a model trained in bf16 serves and evaluates in
    bf16. The file is a pickle: load only trusted checkpoints.

    A JAX checkpoint (``path`` its stem, ``stem.msgpack`` or
    ``stem.json``) adds "history", "train_config" and "rng_key" from the
    ``.json``, and "opt_state" (the optax state as a tree of dicts, its
    leaves on ``device``) and "step" (int) from the ``.msgpack``. Every
    leaf keeps its stored dtype; ``model_config`` is the ``.json``'s own
    dict. The ``.msgpack`` is read once, and each leaf copied once from
    that buffer to ``device``.
    """
    path = Path(path)
    if is_torch_checkpoint(path):
        return _load_torch(path, device)
    meta_file, state_file = _jax_files(path)
    meta = _read_json(meta_file)
    state = flax_msgpack.restore(_read_file(state_file), device=device)
    return {
        "params": state["params"],
        "model_config": _jax_model_config(meta),
        "epoch": meta.get("epoch", 0),
        "best_val_loss": meta.get("best_val_loss", float("inf")),
        "best_val_acc": meta.get("best_val_acc", 0.0),
        "history": meta.get("history", {}),
        "train_config": meta.get("train_config", {}),
        "rng_key": meta.get("rng_key"),
        "opt_state": state.get("opt_state"),
        "step": int(state.get("step", 0)),
    }


def _load_torch(path: Path, device) -> Dict[str, Any]:
    blob = torch.load(path, map_location="cpu", weights_only=False)
    params, cfg, meta = reference_from_blob(blob, device=device)
    out = {
        "params": params,
        "model_config": cfg.to_dict(),
        "epoch": meta.get("epoch", 0),
        "best_val_loss": meta.get("best_val_loss", float("inf")),
        "best_val_acc": meta.get("best_val_acc", 0.0),
    }
    if isinstance(blob, dict):
        out.update({k: blob[k] for k in TRAINER_KEYS if k in blob})
    return out


def save_jax(path, payload: Dict[str, Any]) -> None:
    """Write a JAX checkpoint, the counterpart of the JAX ``save``:
    ``payload["state"]`` (a tree of dicts: "params", "opt_state", "step";
    tensor or numpy leaves) to ``path.msgpack`` in flax's encoding, every
    dict under those three in sorted key order, as the JAX ``save`` leaves
    them (its host copy is a ``tree_map``, which rebuilds each dict
    sorted); and every other entry to ``path.json`` (``json.dump(...,
    indent=2)``).
    Each file goes to a temporary beside it and is renamed into place, so
    a run killed while saving leaves the previous files whole. A no-op on
    every process of a group but process 0 (each calls it after building
    its payload)."""
    if process_group_size()[1] != 0:
        return
    stem = Path(path)
    stem.parent.mkdir(parents=True, exist_ok=True)
    state = {k: _sorted(v) for k, v in payload["state"].items()}
    for suffix, dump in (
            (".msgpack", lambda f: flax_msgpack.write(state, f)),
            (".json", lambda f: f.write(json.dumps(
                {k: v for k, v in payload.items() if k != "state"},
                indent=2).encode()))):
        final = stem.with_suffix(suffix)
        tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
        try:
            with open(tmp, "wb") as f:
                dump(f)
            os.replace(tmp, final)
        finally:
            tmp.unlink(missing_ok=True)


# -- the optax state <-> the port's optimizers -------------------------------

# A leaf's path in a nested dict.
Keys = Tuple[str, ...]


def _walk(tree, prefix: Keys = ()):
    """(path, leaf) of a nested dict, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path: Keys):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _sorted(tree):
    """``tree`` with the keys of every dict sorted (the order in which JAX
    rebuilds a dict)."""
    return {k: _sorted(tree[k]) for k in sorted(tree)} \
        if isinstance(tree, dict) else tree


def _nested(pairs) -> Dict[str, Any]:
    """The nested dict of (path, value) pairs."""
    tree: Dict[str, Any] = {}
    for path, value in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return tree


def _adam_of(chain) -> Optional[Dict[str, Any]]:
    """The ``ScaleByAdamState`` of an optax chain's state, found by its
    keys: its index moves with the clip and the weight decay."""
    if not isinstance(chain, dict):
        return None
    if {"count", "mu", "nu"} <= chain.keys():
        return chain
    for v in chain.values():
        found = _adam_of(v)
        if found is not None:
            return found
    return None


def _is_adam(opt) -> bool:
    return isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))


def _param_paths(params) -> Dict[int, Keys]:
    return {id(t): p for p, t in _walk(params)}


def _live(opt) -> List[torch.Tensor]:
    return [p for g in opt.param_groups for p in g["params"]]


def _torch_state(opt, adam, paths: List[Keys], what: str,
                 shapes: Optional[List[Tuple[int, ...]]] = None):
    """The ``state_dict`` that loads ``adam`` (None for a stateless chain)
    into the torch optimizer ``opt``, leaf i's moments at ``paths[i]`` of
    mu and nu (() for a chain over one array), of ``shapes[i]`` (default:
    the leaf's own)."""
    sd = opt.state_dict()
    if not _is_adam(opt):
        if adam is not None:
            raise ValueError(f"the checkpoint's {what} optimizer state holds "
                             f"adam moments; this trainer runs "
                             f"{type(opt).__name__}")
        return {"state": {}, "param_groups": sd["param_groups"]}
    if adam is None:
        raise ValueError(f"the checkpoint's {what} optimizer state has no "
                         f"adam moments; this trainer runs "
                         f"{type(opt).__name__}")
    counts = torch.as_tensor(adam["count"]).reshape(-1)
    step = counts[0].to("cpu", torch.float32)
    index = [i for g in sd["param_groups"] for i in g["params"]]
    shapes = shapes or [tuple(p.shape) for p in _live(opt)]
    state = {}
    for i, path, shape in zip(index, paths, shapes):
        mu, nu = _at(adam["mu"], path), _at(adam["nu"], path)
        name = "/".join(path) or what
        if not isinstance(mu, torch.Tensor) or \
                not isinstance(nu, torch.Tensor):
            raise ValueError(f"the checkpoint holds no adam moments for "
                             f"{name}")
        if tuple(mu.shape) != shape:
            raise ValueError(f"the checkpoint's moments of {name} are "
                             f"{tuple(mu.shape)}; this trainer's are {shape}")
        state[i] = {"step": step.clone(), "exp_avg": mu, "exp_avg_sq": nu}
    return {"state": state, "param_groups": sd["param_groups"]}


def _table_shapes(split) -> List[Tuple[int, ...]]:
    """The shapes of the whole table state, every slice included (across
    processes each holds its own slices)."""
    table = split.table
    live = (_live(table) if isinstance(table, torch.optim.Optimizer)
            else list(table.values()))
    n = split.slices.n if split.slices is not None else None
    return [tuple(t.shape) if n is None or not t.dim()
            else (n,) + tuple(t.shape[1:]) for t in live]


def _mismatch(what: str, got, want) -> ValueError:
    return ValueError(
        f"the checkpoint's {what} state is {tuple(got)}, this trainer's "
        f"{tuple(want)}: it was written with another --n_devices (the "
        f"table's row slices cannot be remapped); resume with the "
        f"checkpoint's shard count")


def optimizer_state_from_jax(optimizer, opt_state, params
                             ) -> Dict[str, Any]:
    """The ``state_dict`` that loads a JAX checkpoint's ``opt_state`` into
    the port's ``optimizer`` of a trainer whose parameter dict is
    ``params``. Leaves go by their path in ``params``, never by position.

    - A torch optimizer (the full-graph, sharded and one-device sampled
      trainers): the optax chain of ``train/loop.make_optimizer``, its
      ``ScaleByAdamState`` ``count``/``mu``/``nu`` to each leaf's
      ``step``/``exp_avg``/``exp_avg_sq`` (sgd: no state).
    - ``SplitOptimizer`` (``(rest_state, table_state)``): ``rest`` as
      above; ``table`` a torch optimizer over the stacked row slices,
      from the device-major [n, n_loc, D] moments and [n] counts, or the
      factored ``v_row``/``v_col``/``count``. A table of another slice
      count raises.
    - ``CachedOptimizer`` (``(base_state, h_cache)``): ``base`` as above,
      ``cache`` the histories in their stored dtype.
    """
    if hasattr(optimizer, "cache"):
        return {"base": optimizer_state_from_jax(optimizer.base,
                                                 opt_state["0"], params),
                "cache": opt_state["1"]}
    paths = _param_paths(params)

    def path_of(opt):
        return [paths.get(id(p), ()) for p in _live(opt)]

    if hasattr(optimizer, "table"):
        rest = _torch_state(optimizer.rest, _adam_of(opt_state["0"]),
                            path_of(optimizer.rest), "rest")
        table_state, shapes = opt_state["1"], _table_shapes(optimizer)
        if isinstance(optimizer.table, torch.optim.Optimizer):
            adam = _adam_of(table_state)
            if adam is not None and tuple(adam["mu"].shape) != shapes[0]:
                raise _mismatch("table", adam["mu"].shape, shapes[0])
            table = _torch_state(optimizer.table, adam, [()], "table",
                                 shapes)
        else:
            table = {}
            for (k, want), shape in zip(optimizer.table.items(), shapes):
                got = table_state[k]
                if tuple(got.shape) != shape:
                    raise _mismatch(f"table {k}", got.shape, shape)
                table[k] = got.to(want.dtype)
        return {"rest": rest, "table": table}
    return _torch_state(optimizer, _adam_of(opt_state), path_of(optimizer),
                        "model")


def _chain(train_cfg, adam, include_clip: bool) -> Dict[str, Any]:
    """``train/loop.make_optimizer``'s optax chain state, ``adam`` its
    ``ScaleByAdamState`` (every other stage is stateless: ``{}``)."""
    parts: List[Any] = []
    if include_clip and train_cfg.grad_clip and train_cfg.grad_clip > 0:
        parts.append({})
    decay = [{}] if train_cfg.weight_decay else []
    if train_cfg.optimizer == "adam":
        parts += decay + [adam, {}]
    elif train_cfg.optimizer == "adamw":
        parts += [adam] + decay + [{}]
    elif train_cfg.optimizer == "sgd":
        parts += decay + [{}]
    else:
        raise ValueError(f"Unknown optimizer: {train_cfg.optimizer}")
    return {str(i): p for i, p in enumerate(parts)}


def _adam_tree(opt, sd, path_of, count_shape=()) -> Optional[Dict[str, Any]]:
    """The ``ScaleByAdamState`` of the torch optimizer ``opt`` from its
    state dict ``sd`` (None for sgd): each leaf's moments at
    ``path_of(leaf)`` of mu and nu (() for a chain over one array), zeros
    where a leaf has no state yet, and the step as a ``count_shape`` int32
    count."""
    if not _is_adam(opt):
        return None
    index = [i for g in sd["param_groups"] for i in g["params"]]
    mu, nu, step = [], [], 0
    for i, p in zip(index, _live(opt)):
        st = sd["state"].get(i, {})
        if "step" in st:
            step = int(torch.as_tensor(st["step"]).item())
        zero = torch.zeros_like(p, device="cpu")
        mu.append((path_of(p), st.get("exp_avg", zero)))
        nu.append((path_of(p), st.get("exp_avg_sq", zero)))

    def tree(pairs):
        return _nested(pairs) if pairs[0][0] else pairs[0][1]

    return {"count": torch.full(count_shape, step, dtype=torch.int32),
            "mu": tree(mu), "nu": tree(nu)}


def optimizer_state_to_jax(optimizer, params, train_cfg) -> Dict[str, Any]:
    """The inverse of :func:`optimizer_state_from_jax`: the ``opt_state``
    tree that the JAX trainer of the same layout and ``train_cfg`` saves
    (:func:`save_jax` puts its dicts in JAX's order). Across processes
    every process calls it (the sharded table state is gathered)."""
    if hasattr(optimizer, "cache"):
        return {"0": optimizer_state_to_jax(optimizer.base, params,
                                            train_cfg),
                "1": optimizer.cache}
    paths = _param_paths(params)
    path_of = lambda p: paths[id(p)]  # noqa: E731
    if not hasattr(optimizer, "table"):
        return _chain(train_cfg, _adam_tree(
            optimizer, optimizer.state_dict(), path_of), include_clip=True)
    sd = optimizer.state_dict()
    rest = _adam_tree(optimizer.rest, sd["rest"], path_of)
    if rest is not None:
        # JAX's rest tree keeps the table's place, as None.
        for k in ("mu", "nu"):
            rest[k]["encoder"]["node_emb"] = None
    if isinstance(optimizer.table, torch.optim.Optimizer):
        n = _table_shapes(optimizer)[0][0]
        table = _chain(train_cfg, _adam_tree(
            optimizer.table, sd["table"], lambda p: (), count_shape=(n,)),
            include_clip=False)
    else:
        table = dict(sd["table"])
    return {"0": _chain(train_cfg, rest, include_clip=False), "1": table}


def jax_step(opt_state) -> int:
    """The update count that an optax state records: its first adam
    ``count`` or factored-table ``count`` (0 for a stateless chain)."""
    if isinstance(opt_state, dict):
        if "count" in opt_state:
            return int(torch.as_tensor(opt_state["count"]).reshape(-1)[0])
        for v in opt_state.values():
            n = jax_step(v)
            if n:
                return n
    return 0
