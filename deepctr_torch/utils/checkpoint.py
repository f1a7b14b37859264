"""Checkpoints in the JAX package's format, and the parameter converter.

Port of ``deepctr_tpu/utils/checkpoint.py``: the scoring read side, writers
of the same format (scoring parameters, a whole train state, an FM table),
the FM -> FNN hand-off and the pretraining -> SNN hand-off, so checkpoints
move both ways between the packages: an ``np.savez`` of the flattened
pytree (``leaf_0`` ...) and a JSON manifest whose ``scoring`` entry says
where the table and the dense leaves sit.

Two things the JAX side gets from ``jax.tree_util`` and ``ml_dtypes`` are
done here by hand:

- leaf order: JAX flattens dicts in sorted key order and lists in index
  order, so FNN's dense leaves are ``layers[0].b, layers[0].w, layers[1].b,
  ...`` (b before w). :func:`jax_leaves` reproduces that order.
- bfloat16 leaves (``table_dtype="bf16"`` training) are stored as uint16
  bit patterns listed in ``bf16_leaves``; they are widened exactly to f32
  by a 16-bit shift. The reference's ``load_fm_embeddings`` ignores this
  marker and hands FNN the raw uint16 bits of a bf16 FM table; the port's
  honours it.

``load_train_state`` resumes from a train state that either package wrote
(see its docstring for the dropout generator of a JAX-written file).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..optim.dense import AdamState

Tree = Any  # nested dicts and lists with array leaves


def jax_leaves(tree: Tree) -> list:
    """Leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in jax_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in jax_leaves(sub)]
    return [tree]


def _unflatten_like(like: Tree, leaves: list) -> Tree:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(sub) for sub in node]
        return next(it)

    return build(like)


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_manifest(path: str) -> dict:
    """Read the JSON manifest of a checkpoint without loading the arrays."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["manifest"]))


def _host_array(leaf) -> tuple[np.ndarray, bool]:
    """A leaf as numpy, and whether it is bf16 (stored as its uint16 bits,
    since ``np.savez`` has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).cpu().numpy().view(np.uint16), True
        return leaf.cpu().numpy(), False
    return np.asarray(leaf), False


def _write(path: str, leaves: list, manifest: dict, schema=None,
           meta: dict | None = None) -> None:
    """Atomically write ``leaves`` and the manifest, as ``save_pytree``."""
    arrays, bf16 = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"], is_bf16 = _host_array(leaf)
        if is_bf16:
            bf16.append(i)
    manifest = {"n": len(leaves), "bf16_leaves": bf16, **manifest}
    if meta:
        manifest.update(meta)
    if schema is not None:
        manifest["schema_json"] = schema.to_json()
    tmp = path + ".tmp.npz"
    np.savez(tmp, manifest=json.dumps(manifest), **arrays)
    os.replace(tmp, path)


def save_scoring_params(path: str, table: np.ndarray, dense: Tree, *,
                        schema=None, meta: dict | None = None) -> None:
    """Atomically write ``(table, dense)`` as f32 in the JAX package's
    checkpoint format, so that both packages' scoring loaders read it
    (``load_scoring_params`` here and in ``deepctr_tpu``)."""
    # the pytree {"dense", "table"} flattens dense leaves first, then the table
    leaves = [np.asarray(leaf, np.float32)
              for leaf in jax_leaves({"dense": dense, "table": table})]
    n_dense = len(leaves) - 1
    _write(path, leaves, {"scoring": {"table_leaf": n_dense, "dense_start": 0,
                                      "n_dense": n_dense}},
           schema=schema, meta=meta)


def save_train_state(path: str, state, epoch: int = 0,
                     meta: dict | None = None, schema=None) -> None:
    """Save a ``train.TrainState`` with the leaves in the reference's
    ``TrainState`` order: step, table, the sparse optimizer's state, the
    dense parameters, the dense optimizer's state, and last the dropout
    generator's state (where the reference keeps its PRNG key). ``epoch``
    records the epochs completed. A bf16 table is stored as uint16 bits
    with the ``bf16_leaves`` marker, as ``save_pytree`` does; both
    packages' ``--score`` read the result."""
    table, sparse, dense, dense_state = _state_leaves(state)
    leaves = [np.int32(state.step), table, *sparse, *dense, *dense_state,
              state.generator.get_state()]
    _write(path, leaves, {
        "treedef": "deepctr_torch TrainState(step, table, sparse_state, "
                   "dense, dense_state, generator)",
        "epoch": int(epoch),
        "scoring": {"table_leaf": 1, "dense_start": 2 + len(sparse),
                    "n_dense": len(dense)},
    }, schema=schema, meta=meta)


def _state_leaves(state) -> tuple:
    """The tensors of a ``train.TrainState`` in the reference's leaf order:
    ``(table, sparse state, dense, dense state)``. The dense parameters and
    the dense optimizer's per-parameter tensors go in ``jax_leaves`` order
    of the nested names (not ``named_parameters`` order); Adam's state goes
    as optax's ``ScaleByAdamState``: count, every ``mu``, every ``nu``."""
    model = state.model
    params = dict(model.named_parameters())
    names = [key for key in params if key != "table"]

    def ordered(per_param):
        return jax_leaves(_nest(zip(names, per_param)))

    ds = state.dense_state
    dense_state = ([ds.count, *ordered(ds.mu), *ordered(ds.nu)]
                   if isinstance(ds, AdamState) else ordered(ds))
    return (model.table, list(state.sparse_state),
            ordered([params[key] for key in names]), dense_state)


@torch.no_grad()
def load_train_state(path: str, state):
    """Restore a train-state checkpoint written by either package into
    ``state`` (a ``train.TrainState`` built for the same model and
    optimizers, as ``init_state`` gives it), in place, and return it.

    Restored: ``step``; the table, whose dtype must be the state's (a bf16
    table keeps its bits); the sparse optimizer's state; the dense
    parameters; the dense optimizer's state; and the dropout generator. A
    port-written file holds the generator's state in its last leaf. A
    JAX-written one holds a PRNG key ``uint32[2]`` there, whose stream the
    port does not reproduce: the generator is then seeded with the key's
    two words as one 64-bit integer, ``(key[0] << 32) | key[1]``. A leaf
    count, shape or dtype that does not match the state (another model,
    optimizer or ``train.table_dtype``) raises ``ValueError``."""
    table, sparse, dense, dense_state = _state_leaves(state)
    targets = [table, *sparse, *dense, *dense_state]
    manifest = read_manifest(path)
    n = len(targets) + 2   # and the step first, the generator last
    if manifest["n"] != n:
        raise ValueError(
            f"{path}: {manifest['n']} leaves, the train state expects {n} "
            f"(step, table, {len(sparse)} sparse-state, {len(dense)} dense, "
            f"{len(dense_state)} dense-state, generator): model or optimizer "
            f"mismatch")
    bf16 = set(manifest.get("bf16_leaves", ()))
    with np.load(path, allow_pickle=False) as z:
        for i, target in enumerate(targets, start=1):
            a = z[f"leaf_{i}"]
            got = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   if i in bf16 else torch.from_numpy(a))
            if got.shape != target.shape or got.dtype != target.dtype:
                raise ValueError(
                    f"{path}: leaf {i} is {got.dtype}{list(got.shape)}, the "
                    f"train state's is {target.dtype}{list(target.shape)}: "
                    f"model, optimizer or train.table_dtype mismatch")
            target.copy_(got)
        step = int(z["leaf_0"])
        _restore_generator(state.generator, z[f"leaf_{n - 1}"], path)
    state.step = step
    return state


def _restore_generator(generator: torch.Generator, rng: np.ndarray,
                       path: str) -> None:
    """Restore the dropout generator from a file's last leaf: a port-written
    generator state, or a JAX PRNG key ``uint32[2]``, whose two words seed
    the generator as one 64-bit integer."""
    if rng.dtype == np.uint8:
        generator.set_state(torch.from_numpy(rng))
    elif rng.dtype == np.uint32 and rng.shape == (2,):
        generator.manual_seed((int(rng[0]) << 32) | int(rng[1]))
    else:
        raise ValueError(f"{path}: last leaf {rng.dtype}{list(rng.shape)} is "
                         f"neither a generator state nor a JAX PRNG key")


def save_fm_embeddings(path: str, table) -> None:
    """Atomically write a trained FM's ``[V+1, 1+k]`` (w|v) table as the
    reference's ``save_fm_embeddings`` does: one leaf, stored as uint16 bits
    with the ``bf16_leaves`` marker when the table is bf16."""
    _write(path, [table], {"treedef": "PyTreeDef({'fm_table': *})"})


def load_fm_embeddings(path: str) -> np.ndarray:
    """A trained FM's ``[V+1, 1+k]`` (w|v) table as f32, from the file the
    reference's ``save_fm_embeddings`` writes; a bf16 table is decoded."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        if manifest["n"] != 1:
            raise ValueError(f"{path}: {manifest['n']} leaves, not an FM table")
        table = z["leaf_0"]
    if 0 in manifest.get("bf16_leaves", ()):
        return _bf16_to_f32(table)
    return table.astype(np.float32)


def stored_table_dtype(path: str) -> str:
    """The dtype the table is stored in, ``"bf16"`` or ``"f32"``, from the
    manifest of a train-state checkpoint (its ``scoring`` entry names the
    table's leaf) or of the FM file :func:`save_fm_embeddings` writes (one
    leaf)."""
    manifest = read_manifest(path)
    leaf = manifest["scoring"]["table_leaf"] if "scoring" in manifest else 0
    return "bf16" if leaf in manifest.get("bf16_leaves", ()) else "f32"


@torch.no_grad()
def init_fnn_from_fm(model: torch.nn.Module, fm_table: np.ndarray,
                     table_dtype: str = "f32") -> None:
    """Replace FNN's embedding table with the trained FM (w|v) rows, as the
    reference's ``init_fnn_from_fm`` does: the table becomes the FM table in
    the dtype the FM file stores it in (``table_dtype``, see
    :func:`stored_table_dtype`), whatever dtype the model's table had. An f32
    FM file so gives an f32 table where ``train.table_dtype=bf16``
    (``deepctr_tpu/cli.py:277-280``)."""
    if table_dtype not in ("f32", "bf16"):
        raise ValueError(f"table_dtype {table_dtype!r} (f32|bf16)")
    fm_table = torch.tensor(np.asarray(fm_table, np.float32), device=model.table.device)
    if fm_table.shape != model.table.shape:
        raise ValueError(
            f"FM table {tuple(fm_table.shape)} does not match FNN table "
            f"{tuple(model.table.shape)}; train FM with the same schema and k"
        )
    model.table.data = fm_table.to(torch.bfloat16) if table_dtype == "bf16" else fm_table


@torch.no_grad()
def init_snn_from_pretrain(model: torch.nn.Module, table, b1) -> None:
    """Seed SNN's supervised phase from the DAE or RBM pretraining output, as
    the reference's ``init_snn_from_pretrain`` does: the table becomes a
    copy of the pretrained one, in its dtype (the pretraining's f32), and
    ``b1`` is copied in."""
    table = torch.as_tensor(table)
    if table.shape != model.table.shape:
        raise ValueError(
            f"pretrained table {tuple(table.shape)} != SNN table "
            f"{tuple(model.table.shape)}"
        )
    model.table.data = table.to(model.table.device, copy=True)
    model.b1.copy_(torch.as_tensor(b1))


def load_scoring_params(path: str, dense_like: Tree) -> tuple[np.ndarray, Tree]:
    """Load just ``(table, dense)`` as f32 numpy arrays from a checkpoint.

    ``dense_like`` gives the dense pytree's structure (for a port model,
    :func:`dense_structure`)."""
    manifest = read_manifest(path)
    sc = manifest["scoring"]
    n_dense = len(jax_leaves(dense_like))
    if n_dense != sc["n_dense"]:
        raise ValueError(
            f"checkpoint {path} has {sc['n_dense']} dense leaves, model "
            f"expects {n_dense} — model/config mismatch"
        )
    bf16 = set(manifest.get("bf16_leaves", ()))

    def leaf(z, i):
        a = z[f"leaf_{i}"]
        return _bf16_to_f32(a) if i in bf16 else a.astype(np.float32)

    with np.load(path, allow_pickle=False) as z:
        table = leaf(z, sc["table_leaf"])
        dense = [leaf(z, sc["dense_start"] + i) for i in range(n_dense)]
    return table, _unflatten_like(dense_like, dense)


def params_from_jax(table, dense: Tree) -> dict[str, torch.Tensor]:
    """JAX-layout ``(table, dense)`` arrays -> a port model's ``state_dict``.

    ``dense["mlp"]["layers"][0]["w"]`` becomes key ``mlp.layers.0.w``, and
    SNN's ``dense["b1"]`` key ``b1``."""
    state = {"table": torch.tensor(np.asarray(table, np.float32))}

    def walk(node, prefix):
        items = (sorted(node.items()) if isinstance(node, dict)
                 else enumerate(node) if isinstance(node, (list, tuple))
                 else None)
        if items is None:
            state[prefix] = torch.tensor(np.asarray(node, np.float32))
            return
        for key, sub in items:
            walk(sub, f"{prefix}.{key}" if prefix else str(key))

    walk(dense, "")
    return state


def _nest(items) -> Tree:
    """``("mlp.layers.0.w", leaf)`` pairs -> the JAX-layout nested pytree."""
    nested: dict = {}
    for key, leaf in items:
        node = nested
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(key.isdigit() for key in node):
            return [listify(node[key]) for key in sorted(node, key=int)]
        return {key: listify(sub) for key, sub in node.items()}

    return listify(nested)


def dense_structure(model: torch.nn.Module) -> Tree:
    """The structure of a port model's dense pytree, with placeholder
    leaves: the ``dense_like`` of :func:`load_scoring_params`. Nothing is
    copied off the device."""
    return _nest((key, 0) for key in model.state_dict() if key != "table")


def params_to_jax(model: torch.nn.Module) -> tuple[np.ndarray, Tree]:
    """A port model's parameters -> JAX-layout ``(table, dense)`` arrays."""
    state = model.state_dict()
    dense = _nest((key, t.detach().float().cpu().numpy())
                  for key, t in state.items() if key != "table")
    return state["table"].detach().float().cpu().numpy(), dense
