"""The port's per-rank shard checkpoints (``deepctr_torch/parallel/
hostckpt.py``) against the JAX package's ``deepctr_tpu/parallel/hostckpt.py``.

No process group is needed: a rank's shard and its file need only its rank
and the world size, so ``Group(rank=r, world=2, device=cpu)`` is built here
for each rank. The JAX side saves from a two-device mesh of conftest's fake
CPU devices, in one process, so its ``proc0.npz`` holds both ranks' shards:
the port's ``proc0.npz`` and ``proc1.npz`` together must equal it, key for
key and value for value (the generator leaf aside: the port writes its
generator's state where JAX writes its PRNG key, as in the portable
checkpoint).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from deepctr_torch import parallel as par
from deepctr_torch.models import MlpSpec as TMlpSpec
from deepctr_torch.models import make_fnn as t_make_fnn
from deepctr_torch.optim import make_dense_optimizer, make_sparse_optimizer
from deepctr_torch.train import init_state as t_init_state
from deepctr_torch.utils import checkpoint as t_ckpt
from deepctr_tpu import parallel as j_par
from deepctr_tpu.models import MlpSpec, make_fnn
from deepctr_tpu.optim import SparseAdagrad, SparseSgd
from deepctr_tpu.train import init_state as j_init_state
from deepctr_tpu.utils import checkpoint as j_ckpt

K = 3
HIDDEN = (16, 8)
WORLD = 2
CPU = torch.device("cpu")


def _group(rank: int) -> par.Group:
    return par.Group(rank=rank, world=WORLD, device=CPU)


def _jax_state(schema, sparse, table_dtype):
    """A JAX FNN train state whose table, accumulator and dense leaves hold
    seeded values that no initialiser gives."""
    sopt = {"sgd": SparseSgd(0.1), "adagrad": SparseAdagrad(0.1)}[sparse]
    model = make_fnn(schema, k=K, mlp=MlpSpec(hidden=HIDDEN, dropout=0.5))
    state = j_init_state(model, schema, sopt, optax.adagrad(0.05), seed=0,
                         table_dtype=table_dtype)
    rng = np.random.default_rng(5)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    moved = [jnp.asarray(rng.normal(0, 0.1, x.shape).astype(np.float32), x.dtype)
             if x.ndim >= 1 and jnp.issubdtype(x.dtype, jnp.floating) else x
             for x in leaves]
    moved[0] = jnp.asarray(7, jnp.int32)   # the step
    return jax.tree_util.tree_unflatten(treedef, moved)


def _port_state(schema, sparse, table_dtype, k=K, seed=3):
    model = t_make_fnn(schema, k=k, mlp=TMlpSpec(hidden=HIDDEN, dropout=0.5),
                       device="cpu")
    return t_init_state(model, schema, make_sparse_optimizer(sparse, 0.1),
                        make_dense_optimizer("adagrad", 0.05), seed=seed,
                        table_dtype=table_dtype)


def _port_from_jax(schema, jstate, sparse, table_dtype, tmp_path):
    """The port's state holding the JAX state's values, by the portable
    checkpoint both packages read."""
    path = str(tmp_path / "portable.npz")
    j_ckpt.save_train_state(path, jstate, epoch=0)
    return t_ckpt.load_train_state(path, _port_state(schema, sparse, table_dtype))


def _port_shards(state, dirpath, epoch=3):
    """Every rank's shard of ``state`` saved to ``dirpath``; the sharded
    states, by rank."""
    out = []
    for r in range(WORLD):
        sst = par.sharded_state_from_state(state.clone(), _group(r))
        par.save_host_shards(dirpath, sst, _group(r), epoch=epoch)
        out.append(sst)
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    """bf16 entries as their uint16 bits: the port's, and JAX's ``|V2``."""
    return a.view(np.uint16) if a.dtype in (np.dtype("V2"), ml_dtypes.bfloat16) else a


def _files(dirpath):
    out = {}
    for name in sorted(os.listdir(dirpath)):
        with np.load(os.path.join(dirpath, name)) as z:
            out[name] = {key: z[key] for key in z.files}
    return out


def _sst_leaves(sst) -> list[torch.Tensor]:
    table, sparse, dense, dense_state = t_ckpt._state_leaves(sst)
    return [torch.tensor(sst.step), table, *sparse, *dense, *dense_state,
            sst.generator.get_state()]


def _assert_same_state(a, b):
    la, lb = _sst_leaves(a), _sst_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"leaf {i} differs"


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sparse", ["sgd", "adagrad"])
def test_shard_files_equal_jax(tiny_schema, tmp_path, sparse, table_dtype):
    """The port's two rank files, taken together, equal the JAX package's
    file of a two-device mesh for the same parameters."""
    jstate = _jax_state(tiny_schema, sparse, table_dtype)
    j_par.save_host_shards(str(tmp_path / "jax"),
                           j_par.sharded_state_from_state(jstate, j_par.make_data_mesh(2)),
                           epoch=3)
    state = _port_from_jax(tiny_schema, jstate, sparse, table_dtype, tmp_path)
    _port_shards(state, str(tmp_path / "port"))

    (want,) = _files(str(tmp_path / "jax")).values()
    got = _files(str(tmp_path / "port"))
    assert sorted(got) == ["proc0.npz", "proc1.npz"]
    n = int(want["__nleaves"])
    generator = f"r{n - 1}"
    if table_dtype == "bf16":
        for part in got.values():
            np.testing.assert_array_equal(part.pop("__bf16_leaves"), [1])
    union = {}
    for part in got.values():
        for key, a in part.items():
            if key in union:   # replicated leaves: the same on every rank
                np.testing.assert_array_equal(_bits(a), _bits(union[key]))
            union[key] = a
    assert sorted(union) == sorted(want)
    for key in sorted(want):
        if key == generator:
            continue
        g, w = _bits(union[key]), _bits(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sparse", ["sgd", "adagrad"])
def test_shard_files_round_trip(tiny_schema, tmp_path, sparse, table_dtype):
    """Save every rank's shard, load each into a freshly packed state built
    from another seed: every leaf, the step, the generator and the epoch
    come back bit for bit."""
    state = _port_state(tiny_schema, sparse, table_dtype, seed=0)
    with torch.no_grad():
        state.table.add_(0.25)
        for t in state.sparse_state:
            t.add_(2.0)
    state.step = 11
    torch.randint(0, 10, (5,), generator=state.generator)   # move the generator
    saved = _port_shards(state, str(tmp_path / "ck"), epoch=4)
    for r in range(WORLD):
        like = par.sharded_state_from_state(
            _port_state(tiny_schema, sparse, table_dtype, seed=9), _group(r))
        got, epoch = par.load_host_shards(str(tmp_path / "ck"), like, _group(r))
        assert epoch == 4 and got is like
        _assert_same_state(got, saved[r])


def test_jax_written_bf16_file_loads_on_the_port(tiny_schema, tmp_path):
    """The reference writes a bf16 leaf as ``|V2`` and cannot restore it
    itself (``jax.device_put`` refuses the dtype); the port reads it as
    bf16 bits. The JAX file holds both ranks' shards, so each rank of the
    port loads it as its own file."""
    jstate = _jax_state(tiny_schema, "adagrad", "bf16")
    jsst = j_par.sharded_state_from_state(jstate, j_par.make_data_mesh(2))
    jdir = str(tmp_path / "jax")
    j_par.save_host_shards(jdir, jsst, epoch=2)
    with np.load(os.path.join(jdir, "proc0.npz")) as z:
        assert z["s1__0_0"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        j_par.load_host_shards(jdir, jsst)
    shutil.copy(os.path.join(jdir, "proc0.npz"), os.path.join(jdir, "proc1.npz"))

    want = _port_shards(_port_from_jax(tiny_schema, jstate, "adagrad", "bf16",
                                       tmp_path), str(tmp_path / "port"))
    for r in range(WORLD):
        like = par.sharded_state_from_state(
            _port_state(tiny_schema, "adagrad", "bf16", seed=9), _group(r))
        got, epoch = par.load_host_shards(jdir, like, _group(r))
        assert epoch == 2 and got.table.dtype == torch.bfloat16
        # every leaf but the generator, which JAX holds as a PRNG key
        for i, (x, y) in enumerate(zip(_sst_leaves(got)[:-1], _sst_leaves(want[r])[:-1])):
            assert x.dtype == y.dtype and torch.equal(x, y), f"leaf {i} differs"
        key = np.asarray(jstate.rng)
        gen = torch.Generator().manual_seed((int(key[0]) << 32) | int(key[1]))
        assert torch.equal(got.generator.get_state(), gen.get_state())


@pytest.mark.parametrize("change,match", [
    ("optimizer", "leaves"),
    ("k", "world size"),
    ("table_dtype", "table_dtype"),
    ("rank", "missing"),
])
def test_load_refuses_a_mismatch(tiny_schema, tmp_path, change, match):
    """Another optimizer (leaf count), another width (shape), another table
    dtype, and a file without this rank's shard each raise, naming the
    cause."""
    ck = str(tmp_path / "ck")
    state = _port_state(tiny_schema, "adagrad", "f32")
    par.save_host_shards(ck, par.sharded_state_from_state(state, _group(0)), _group(0))
    rank = 0
    kw = {"sparse": "adagrad", "table_dtype": "f32"}
    if change == "optimizer":
        kw["sparse"] = "sgd"
    elif change == "table_dtype":
        kw["table_dtype"] = "bf16"
    elif change == "rank":
        shutil.copy(os.path.join(ck, "proc0.npz"), os.path.join(ck, "proc1.npz"))
        rank = 1
    like = _port_state(tiny_schema, k=4 if change == "k" else K, **kw)
    like = par.sharded_state_from_state(like, _group(rank))
    with pytest.raises(ValueError, match=match):
        par.load_host_shards(ck, like, _group(rank))
