"""The dense-mode sparse Adagrad kernel (``csrc/sparse_adagrad.cu``) against
its plain version on the card, bit for bit.

Marked ``card``: each test skips without a CUDA device, decided inside the
test. This file imports no JAX, so it runs on the machine with the card
(``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_sparse_kernel.py``); ``chip_smoke.py`` phase 26 holds the
kernel to the same at iPinYou's full shape, and phase 27 at DLRM's (D =
128, 1,753,088 occurrences, 26.5 M rows).
"""

import numpy as np
import pytest
import torch

LR, EPS = 0.05 * 0.9, 1e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda", torch.cuda.current_device())


def _batches(v, d, m, seed, dev):
    """Three batches of Zipf-like ids with duplicates, ids equal to V (dropped)
    and a pad id V - 1 whose gradient rows are 0."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        ids = (rng.zipf(1.2, m) - 1) % (v + 1)
        ids[rng.random(m) < 0.1] = v - 1
        rows = rng.normal(0.0, 1e-3, (m, d)).astype(np.float32)
        rows[ids == v - 1] = 0.0
        out.append((torch.from_numpy(ids).long().to(dev), torch.from_numpy(rows).to(dev)))
    return out


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _split_rows(ids, v, d):
    """The rows of ``ids`` in [0, V) with more than the kernel's chunk of
    occurrences."""
    from deepctr_torch.ops.kernels import sparse as k_sparse

    _, counts = torch.unique(ids[ids < v], return_counts=True)
    return int((counts > k_sparse.chunk(ids.shape[0], d, ids.device)).sum())


def _hot_batches(v, d, kind, dev):
    """Three batches of ``kind``: ``one`` every occurrence on one id;
    ``hot`` three ids of many chunks each among uniform ids, with ids equal
    to V (dropped) between them; ``distinct`` no id twice."""
    rng = np.random.default_rng(v + d)
    out = []
    for b in range(3):
        if kind == "one":
            ids = np.full(2053, (7 * b) % v)
        elif kind == "hot":
            ids = rng.integers(0, v, 6000)
            hot = rng.random(ids.shape[0])
            ids[hot < 0.3] = 3
            ids[(hot >= 0.3) & (hot < 0.6)] = v - 2
            ids[(hot >= 0.6) & (hot < 0.75)] = b
            ids[hot >= 0.9] = v
        else:
            ids = rng.permutation(v)[:2000]
        rows = rng.normal(0.0, 1e-3, (ids.shape[0], d)).astype(np.float32)
        out.append((torch.from_numpy(ids).long().to(dev), torch.from_numpy(rows).to(dev)))
    return out


@pytest.mark.card
@pytest.mark.parametrize("shape", [(1000, 1, 300), (5000, 11, 4096), (300, 17, 9000),
                                   (40000, 128, 60000)])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_kernel_equals_plain(table_dtype, shape):
    """Three updates, eager and then in a CUDA graph replayed on the second
    and third batches: table and accumulator equal to the plain version's
    bit for bit; the rows written counted on the device."""
    from deepctr_torch.ops.kernels import sparse as k_sparse

    dev = _card()
    v, d, m = shape
    gen = torch.Generator(device=dev).manual_seed(v + d)
    start = (torch.randn(v, d, generator=gen, device=dev) * 0.01).to(table_dtype)
    plain = (start.clone(), torch.zeros(v, d, device=dev))
    kern = (start.clone(), torch.zeros(v, d, device=dev))
    batches = _batches(v, d, m, d, dev)
    written, split = k_sparse.rows_written(dev), k_sparse.rows_split(dev)
    for ids, rows in batches:
        k_sparse.adagrad_dense_plain(*plain, ids, rows, LR, EPS)
        k_sparse.adagrad_dense_update(*kern, ids, rows, LR, EPS)
    torch.cuda.synchronize()
    for got, want in zip(kern, plain):
        assert torch.equal(_bits(got), _bits(want))
    distinct = sum(int(torch.unique(ids[ids < v]).numel()) for ids, _ in batches)
    assert k_sparse.rows_written(dev) - written == distinct
    assert k_sparse.rows_split(dev) - split == sum(_split_rows(ids, v, d) for ids, _ in batches)

    graphed = (start.clone(), torch.zeros(v, d, device=dev))
    ids, rows = (t.clone() for t in batches[0])
    k_sparse.adagrad_dense_update(*graphed, ids, rows, LR, EPS)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.graph(graph, stream=stream):
        k_sparse.adagrad_dense_update(*graphed, ids, rows, LR, EPS)
    for b_ids, b_rows in batches[1:]:
        ids.copy_(b_ids)
        rows.copy_(b_rows)
        graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(graphed, plain):
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.card
def test_capture_without_workspace_raises():
    """A capture that would have to make the workspace raises."""
    from deepctr_torch.ops.kernels import sparse as k_sparse

    dev = _card()
    table, acc = torch.zeros(50, 3, device=dev), torch.zeros(50, 3, device=dev)
    ids, rows = torch.zeros(8, dtype=torch.int64, device=dev), torch.ones(8, 3, device=dev)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="workspace"):
        with torch.cuda.graph(graph):
            k_sparse.adagrad_dense_update(table, acc, ids, rows, LR, EPS)


@pytest.mark.card
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_one_workspace_an_accumulator_grows_to_the_largest_batch(table_dtype):
    """One accumulator at a small batch, captured in a graph there, then at a
    larger batch (its one workspace grows), then the graph replayed and a
    small batch run eagerly: the plain version's bits throughout; a capture
    that would have to grow the workspace raises."""
    from deepctr_torch.ops.kernels import sparse as k_sparse

    dev = _card()
    v, d = 2000, 5
    small, large = _batches(v, d, 500, 1, dev), _batches(v, d, 3000, 2, dev)
    start = (torch.randn(v, d, device=dev) * 0.01).to(table_dtype)
    plain = (start.clone(), torch.zeros(v, d, device=dev))
    kern = (start.clone(), torch.zeros(v, d, device=dev))
    ids, rows = (t.clone() for t in small[0])
    k_sparse.adagrad_dense_update(*kern, ids, rows, LR, EPS)
    k_sparse.adagrad_dense_plain(*plain, ids, rows, LR, EPS)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.graph(graph, stream=stream):
        k_sparse.adagrad_dense_update(*kern, ids, rows, LR, EPS)
    k_sparse.adagrad_dense_update(*kern, *large[0], LR, EPS)
    k_sparse.adagrad_dense_plain(*plain, *large[0], LR, EPS)
    ids.copy_(small[1][0])
    rows.copy_(small[1][1])
    graph.replay()
    k_sparse.adagrad_dense_plain(*plain, *small[1], LR, EPS)
    k_sparse.adagrad_dense_update(*kern, *small[2], LR, EPS)
    k_sparse.adagrad_dense_plain(*plain, *small[2], LR, EPS)
    torch.cuda.synchronize()
    for got, want in zip(kern, plain):
        assert torch.equal(_bits(got), _bits(want))
    ws = k_sparse._WORKSPACES[id(kern[1])]
    assert ws.counts.shape[0] == 3000 and len(ws.retired) == 1
    assert ws.split_sums.shape == (3000 // (k_sparse.chunk(3000, d, dev) + 1), d)
    assert ws.owner.shape[0] == v and bool((ws.owner == 2**31 - 1).all())
    assert not (bool(ws.counts.any()) or bool(ws.split_sums.any())
                or bool(ws.split_done.any()))

    more_ids, more_rows = _batches(v, d, 4000, 3, dev)[0]
    with pytest.raises(RuntimeError, match="workspace"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
            k_sparse.adagrad_dense_update(*kern, more_ids, more_rows, LR, EPS)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["one", "hot", "distinct"])
@pytest.mark.parametrize("d", [1, 11, 128, 200, 256])
def test_kernel_splits_hot_rows(kind, d):
    """Rows of more than one chunk (``chunk(M, D)`` occurrences) in an update:
    every occurrence on one id, a few hot ids with dropped ids between them,
    and no id twice; at widths below a warp, of one tile (vector rows at
    128), of two tiles and of two vector tiles. Three eager updates and an
    eager update then two graph replays: the plain version's bits, the rows
    written and the rows split counted on the device, replays included, and
    the workspace clean after each."""
    from deepctr_torch.ops.kernels import sparse as k_sparse

    dev = _card()
    v = 3000
    batches = _hot_batches(v, d, kind, dev)
    start = torch.randn(v, d, device=dev) * 0.01
    plain = (start.clone(), torch.zeros(v, d, device=dev))
    kern = (start.clone(), torch.zeros(v, d, device=dev))
    split_want = [_split_rows(ids, v, d) for ids, _ in batches]
    written, split = k_sparse.rows_written(dev), k_sparse.rows_split(dev)
    for ids, rows in batches:
        k_sparse.adagrad_dense_plain(*plain, ids, rows, LR, EPS)
        k_sparse.adagrad_dense_update(*kern, ids, rows, LR, EPS)
    torch.cuda.synchronize()
    for got, want in zip(kern, plain):
        assert torch.equal(_bits(got), _bits(want))
    distinct = sum(int(torch.unique(ids[ids < v]).numel()) for ids, _ in batches)
    assert k_sparse.rows_written(dev) - written == distinct
    assert k_sparse.rows_split(dev) - split == sum(split_want)
    assert (sum(split_want) == 0) == (kind == "distinct")
    ws = k_sparse._WORKSPACES[id(kern[1])]
    assert not (bool(ws.counts.any()) or bool(ws.split_sums.any())
                or bool(ws.split_done.any()))

    graphed = (start.clone(), torch.zeros(v, d, device=dev))
    ids, rows = (t.clone() for t in batches[0])
    k_sparse.adagrad_dense_update(*graphed, ids, rows, LR, EPS)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.graph(graph, stream=stream):
        k_sparse.adagrad_dense_update(*graphed, ids, rows, LR, EPS)
    written, split = k_sparse.rows_written(dev), k_sparse.rows_split(dev)
    for b_ids, b_rows in batches[1:]:
        ids.copy_(b_ids)
        rows.copy_(b_rows)
        graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(graphed, plain):
        assert torch.equal(_bits(got), _bits(want))
    assert k_sparse.rows_written(dev) - written == distinct - int(
        torch.unique(batches[0][0][batches[0][0] < v]).numel())
    assert k_sparse.rows_split(dev) - split == sum(split_want[1:])
    ws = k_sparse._WORKSPACES[id(graphed[1])]
    assert not (bool(ws.counts.any()) or bool(ws.split_sums.any())
                or bool(ws.split_done.any()) or bool(ws.scratch[1:4].any()))
