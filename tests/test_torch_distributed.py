"""``train.distributed`` on the port: rank-local streaming with agreed step
counts (``parallel/group.py::RankLocalStream``, ``cli.load_data``) on two
gloo ranks, against the reference's process partition and the
single-process run.

Rank r's stream must equal the reference's ``StreamSource(process_index=r,
process_count=2)`` batch for batch; a shard's row count must equal what the
parsers read; a distributed run over equal shards must be the
single-process run fed each step's rank-local batches concatenated in rank
order (``tools/multihost_sim.py`` phase 5's check); a run over unequal
shards must end, every rank taking the agreed step count; and a rank-local
batch must never be cut again.
"""

import json
import os

import numpy as np
import pytest
import torch

from deepctr_torch import cli as t_cli
from deepctr_torch import parallel as par
from deepctr_torch.config import RunConfig as TRunConfig
from deepctr_torch.data import Batch, make_schema, native, parser
from deepctr_torch.data import featindex as fidx
from deepctr_torch.data import synthetic
from deepctr_torch.data.cache import write_cache
from deepctr_torch.data.criteo import criteo_schema, parse_criteo_file
from deepctr_torch.data.stream import StreamSource
from deepctr_torch.train import fit, init_state
from deepctr_tpu.data import make_schema as j_make_schema
from deepctr_tpu.data import stream as j_stream
from test_torch_ranks import torchrun
from test_torch_sharded_cli import _stream_config, _write_days

# tests/test_torch_sharded_cli.py's: the sharded and single-process
# trajectories sum in other orders
RTOL, ATOL = 1e-4, 1e-5
# a run whose ranks disagree on the step count hangs in a collective; two
# ranks on these few rows end in seconds
STREAM_TIMEOUT = 150
SPECS = [("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)]
BATCH = 128
CPU = torch.device("cpu")


def _group(rank, world=2):
    return par.Group(rank=rank, world=world, device=CPU)


def _shards(tmp_path, rows, seed=1):
    schema = make_schema(SPECS)
    sp = str(tmp_path / "schema.json")
    with open(sp, "w") as f:
        f.write(schema.to_json())
    paths = []
    for i, n in enumerate(rows):
        paths.append(str(tmp_path / f"shard_{i}.yx"))
        synthetic.write_yx_file(synthetic.generate(schema, num_examples=n, k=3,
                                                   seed=seed + i), paths[-1])
    test = str(tmp_path / "test.yx")
    synthetic.write_yx_file(synthetic.generate(schema, num_examples=256, k=3,
                                               seed=seed + 99), test)
    return sp, paths, test


def _overrides(sp, paths, test, ckpt):
    return ["model.name=fnn", "model.k=3", "model.hidden=16", "model.dropout=0.0",
            f"data.schema_path={sp}", "data.stream=true",
            f"data.train_path={','.join(paths)}", f"data.test_path={test}",
            "data.stream_buffer_rows=256", f"train.batch_size={BATCH}",
            "train.epochs=2", "train.capacity_factor=8.0", "train.sharded=true",
            "train.distributed=true", f"train.checkpoint_path={ckpt}"]


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_local_stream_equals_the_reference_partition(tmp_path, rank):
    """``load_data`` under the key gives rank r the reference's process
    source: shards ``epoch_order[r::2]`` in batches of B/2 rows, batch for
    batch over two epochs."""
    sp, paths, test = _shards(tmp_path, [500, 300, 400])
    cfg = TRunConfig().apply_overrides(_overrides(sp, paths, test, ""))
    _, source, *_ = t_cli.load_data(cfg, _group(rank))
    assert (source.process_index, source.process_count, source.batch_size) == (
        rank, 2, BATCH // 2)
    ref = j_stream.StreamSource(paths=paths, schema=j_make_schema(SPECS),
                                batch_size=BATCH // 2, buffer_rows=256, seed=0,
                                process_index=rank, process_count=2)
    for epoch in range(2):
        got, want = list(source.batches(epoch)), list(ref.batches(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.ids, w.ids)
            np.testing.assert_array_equal(g.labels, w.labels)


# blank and whitespace lines, CRLF ends, a last line with and without its
# newline, a tail of blanks; ids within a featindex of 15 old indices
_YX = (b"\n  \n1 1:1 5:1\r\n\t\n0 2:1 7:1 12:1\n\n \r\n1 3:1\n0 1:1   \n  \t ",
       b"0 4:1\r\n\r\n1 6:1 9:1\n0 2:1")
_CRITEO_ROW = b"\t5\t\t3" + b"\t" * 10 + b"\tab12cd34" * 26


def _criteo(*labels_and_ends):
    return b"".join(label + _CRITEO_ROW + end for label, end in labels_and_ends)


_TSV = (b"\n" + _criteo((b"1", b"\r\n\r\n"), (b"0", b"\n\n"), (b"1", b"")),
        _criteo((b"0", b"\n"), (b"1", b"\r\n")) + b"\n\n")


def _featindex(tmp_path):
    lines = ["truncate\t0"]
    for val in range(5):
        for k, field in enumerate(("weekday", "hour", "region")):
            lines.append(f"{field}:{val}\t{1 + 3 * val + k}")
    fp = tmp_path / "featindex.txt"
    fp.write_text("\n".join(lines) + "\n")
    return fidx.load_featindex(str(fp))


@pytest.mark.parametrize("chunk_bytes", [16 << 20, 24])
@pytest.mark.parametrize("fmt", ["yx", "criteo", "yx-featindex", "npz"])
def test_count_rows_equals_the_parsers(tmp_path, fmt, chunk_bytes):
    """``StreamSource.count_rows`` on edge-case files equals the rows the
    stream parses from them (``_file_chunks``, whose chunks it cuts alike)
    and the whole-file parsers' rows; an empty file has none."""
    fi = None
    if fmt == "criteo":
        schema, contents, suffix = criteo_schema(100), _TSV, ".tsv"
    elif fmt == "yx-featindex":
        fi = _featindex(tmp_path)
        schema, contents, suffix = fi.schema, _YX, ".yx"
    else:
        schema, contents, suffix = make_schema(SPECS), _YX, ".yx"
    paths = []
    for i, data in enumerate(contents + (b"",)):
        paths.append(str(tmp_path / f"f{i}{suffix}"))
        with open(paths[-1], "wb") as f:
            f.write(data)
    if fmt == "npz":
        for i, p in enumerate(paths[:-1]):
            labels, ids = native.parse_yx_file(p, schema)
            paths[i] = str(tmp_path / f"f{i}.cache.npz")
            write_cache(paths[i], ids, labels, schema)
        paths.pop()
    source = StreamSource(paths=paths, schema=schema, batch_size=2,
                          fmt="yx" if fmt == "npz" else fmt, featindex=fi,
                          chunk_bytes=chunk_bytes)
    want = {"criteo": [3, 2, 0]}.get(fmt, [4, 3, 0])
    for p, n in zip(source.paths, want):
        streamed = sum(len(labels) for labels, _ in source._file_chunks(p))
        if fmt == "criteo":
            parsed = [len(parse_criteo_file(p, schema, use_native=u)[0])
                      for u in (True, False)]
        elif fmt == "yx-featindex":
            parsed = [len(fidx.parse_yx_file(p, fi)[0])]
        elif fmt == "yx":
            parsed = [len(native.parse_yx_file(p, schema)[0]),
                      len(parser.parse_yx_file(p, schema)[0])]
        else:
            parsed = []
        assert [source.count_rows(p)] * (2 + len(parsed)) == [n, streamed, *parsed], p


def test_distributed_stream_matches_the_concatenated_rank_streams(tmp_path):
    """Two ranks over four equal shards, two epochs: the host shards' table
    and accumulator equal, within the sharded tests' tolerance, the
    single-process run fed, each step, rank 0's local batch and then rank
    1's, and the step counts are equal (the config's scan route: 20 steps
    an epoch in chunks of 8, the third padded); nothing is skipped."""
    sp, paths, test = _shards(tmp_path, [640] * 4)
    ckpt = str(tmp_path / "ck.npz")
    metrics = str(tmp_path / "m.jsonl")
    overrides = _overrides(sp, paths, test, ckpt)
    torchrun(overrides + [f"train.metrics_path={metrics}", "--device", "cpu"],
             timeout=STREAM_TIMEOUT)
    events = [json.loads(line) for line in open(metrics)]
    steps = [e for e in events if e.get("event") == "epoch_steps"]
    assert [(e["steps"], e["rows_skipped"]) for e in steps] == [(20, 0)] * 2

    cfg = TRunConfig().apply_overrides(overrides)
    schema, *_, te_ids, te_labels = t_cli.load_data(cfg)
    sources = [t_cli.load_data(cfg, _group(r))[1] for r in range(2)]

    class RankOrder:
        def scan_chunks(self, epoch, k):
            for parts in zip(*(s.scan_chunks(epoch, k) for s in sources)):
                yield parts[0][0], tuple(np.concatenate([c[i] for _, c in parts], axis=1)
                                         for i in range(3))

    model = t_cli.build_model(cfg, schema, CPU)
    sopt, dopt = t_cli.build_optimizers(cfg)
    state = init_state(model, schema, sopt, dopt, seed=cfg.train.seed)
    res = fit(model, schema, None, None, te_ids, te_labels, sparse_opt=sopt,
              dense_opt=dopt, batch_size=BATCH, epochs=2, seed=cfg.train.seed,
              state=state, train_source=RankOrder(), prefetch=False,
              scan_steps=cfg.train.scan_steps)
    assert res.state.step == 2 * 24

    files = []
    for r in range(2):
        with np.load(os.path.join(ckpt + ".hostshards", f"proc{r}.npz")) as z:
            files.append({k: z[k] for k in z.files})
    rows = files[0]["s1__0_0"].shape[0]
    assert int(files[0]["r0"]) == int(files[1]["r0"]) == 2 * 24
    vp = schema.padded_vocab_size
    for leaf, want in ((1, res.state.table), (2, res.state.sparse_state.acc)):
        stored = np.concatenate([files[r][f"s{leaf}__{r * rows}_0"] for r in range(2)])
        got = par.unpack_table(torch.from_numpy(stored), vp, 2)
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                   rtol=RTOL, atol=ATOL)
    assert not os.path.exists(ckpt) and not os.path.exists(ckpt + ".fm_table")


def test_distributed_stream_of_unequal_shards_takes_the_agreed_steps(tmp_path):
    """``configs/criteo_stream_stretch.json`` shrunk, with
    ``train.distributed``: three Criteo days of unequal lengths over two
    ranks. It ends within its timeout; each epoch takes ``min_r
    floor(rows_r / (B/2))`` steps, and ``rows_skipped`` counts the longer
    rank's full batches left, as the file lengths and the reference's
    partition give them."""
    rows = [1200, 1000, 800]
    days = _write_days(tmp_path, rows)
    args = _stream_config(tmp_path, days) + ["train.epochs=2"]
    metrics, ckpt = str(tmp_path / "m.jsonl"), str(tmp_path / "s.npz")
    torchrun(args + ["train.distributed=true", f"train.metrics_path={metrics}",
                     f"train.checkpoint_path={ckpt}", "--device", "cpu"],
             timeout=STREAM_TIMEOUT)
    events = [json.loads(line) for line in open(metrics)]
    got = [(e["epoch"], e["steps"], e["rows_skipped"]) for e in events
           if e.get("event") == "epoch_steps"]
    local = 256 // 2
    want = []
    for epoch in range(2):
        full = []
        for r in range(2):
            ref = j_stream.StreamSource(paths=days, schema=j_make_schema(SPECS),
                                        batch_size=local, process_index=r,
                                        process_count=2)
            full.append(sum(rows[ref.paths.index(p)] for p in ref._epoch_paths(epoch))
                        // local)
        want.append((epoch, min(full), (sum(full) - 2 * min(full)) * local))
    assert got == want
    assert any(skipped for _, _, skipped in got)
    recs = [e for e in events if "auc" in e]
    assert len(recs) == 2 and all(r["dropped_ids"] == 0 for r in recs)
    with np.load(os.path.join(ckpt + ".hostshards", "proc1.npz")) as z:
        assert int(z["r0"]) == sum(8 * -(-steps // 8) for _, steps, _ in want)


def test_a_rank_local_batch_is_not_cut_again():
    """The hazard the reference names (``deepctr_tpu/cli.py:461-465``): B/N
    rows that divide by N again would be cut a second time without error.
    ``local_batch`` given the global size refuses a rank's share, and the
    rank-local route's check refuses a global batch."""
    g = _group(1)
    ids = np.arange(2 * BATCH, dtype=np.int32).reshape(BATCH, 2)
    full = Batch(ids, np.zeros(BATCH, np.float32), np.ones(BATCH, np.float32))
    share = par.local_batch(full, g, BATCH)
    np.testing.assert_array_equal(share.ids, ids[BATCH // 2:])
    with pytest.raises(ValueError, match="a rank's share already"):
        par.local_batch(share, g, BATCH)
    assert t_cli._local_rows(share, g, global_rows=BATCH) is share
    with pytest.raises(ValueError, match="rank-local batch"):
        t_cli._local_rows(full, g, global_rows=BATCH)


def test_rank_local_stream_stops_at_the_agreed_count(tmp_path):
    """In one process, the ``RankLocalStream`` of the rank that holds the
    longest shard in a world of two yields the agreed steps, fewer than its
    stream has, logs the rows skipped, and closes its stream."""
    sp, paths, test = _shards(tmp_path, [900, 300, 300])
    cfg = TRunConfig().apply_overrides(_overrides(sp, paths, test, ""))
    order = StreamSource(paths=paths, schema=make_schema(SPECS),
                         batch_size=1).epoch_order(0)
    rank = order.index(paths[0]) % 2
    source = t_cli.load_data(cfg, _group(rank))[1]
    rows = {p: source.count_rows(p) for p in source.paths}
    assert rows == dict(zip(paths, [900, 300, 300]))
    logged = []
    stream = par.RankLocalStream(source, _group(rank), rows, logged.append)
    full = [sum(rows[p] for p in order[r::2]) // 64 for r in range(2)]
    assert len(list(source.batches(0))) == full[rank] > min(full)
    assert len(list(stream.batches(0))) == min(full)
    assert logged == [{"event": "epoch_steps", "epoch": 0, "steps": min(full),
                       "rows_skipped": (full[rank] - min(full)) * 64}]


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_local_scan_chunks_equal_the_reference(tmp_path, rank):
    """On equal shards rank r's ``RankLocalStream.scan_chunks`` is the
    reference's process-local ``StreamSource.scan_chunks``, chunk for chunk
    over two epochs (20 steps an epoch: chunks of 8, 8 and 4 padded with 4
    weight-0 steps), with one ``epoch_steps`` event an epoch."""
    sp, paths, test = _shards(tmp_path, [640] * 4)
    cfg = TRunConfig().apply_overrides(_overrides(sp, paths, test, ""))
    source = t_cli.load_data(cfg, _group(rank))[1]
    logged = []
    stream = par.RankLocalStream(source, _group(rank), dict.fromkeys(paths, 640),
                                 logged.append)
    ref = j_stream.StreamSource(paths=paths, schema=j_make_schema(SPECS),
                                batch_size=BATCH // 2, buffer_rows=256, seed=0,
                                process_index=rank, process_count=2)
    for epoch in range(2):
        got, want = list(stream.scan_chunks(epoch, 8)), list(ref.scan_chunks(epoch, 8))
        assert [nb for nb, _ in got] == [nb for nb, _ in want] == [8, 8, 4]
        for (_, g), (_, w) in zip(got, want):
            for a, b in zip(g, w, strict=True):
                assert a.shape == b.shape and a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert [(e["epoch"], e["steps"], e["rows_skipped"]) for e in logged] == [
        (0, 20, 0), (1, 20, 0)]


def test_rank_local_scan_chunks_stop_at_the_agreed_count_and_pad(tmp_path):
    """On unequal shards the rank that holds the longest one cuts the
    agreed steps, fewer than its stream has, into chunks of 4: the last
    holds the rest of the agreed steps and weight-0 pad steps of pad ids
    and label 0, and the real steps are its first batches."""
    sp, paths, test = _shards(tmp_path, [900, 300, 300])
    cfg = TRunConfig().apply_overrides(_overrides(sp, paths, test, ""))
    order = StreamSource(paths=paths, schema=make_schema(SPECS),
                         batch_size=1).epoch_order(0)
    rank = order.index(paths[0]) % 2
    source = t_cli.load_data(cfg, _group(rank))[1]
    rows = dict(zip(paths, [900, 300, 300]))
    steps, _ = par.RankLocalStream(source, _group(rank), rows).epoch_steps(0)
    batches = list(source.batches(0))
    assert len(batches) > steps and steps % 4
    chunks = list(par.RankLocalStream(source, _group(rank), rows).scan_chunks(0, 4))
    assert [nb for nb, _ in chunks] == [4] * (steps // 4) + [steps % 4]
    ids = np.concatenate([c[0] for _, c in chunks])
    labels = np.concatenate([c[1] for _, c in chunks])
    weights = np.concatenate([c[2] for _, c in chunks])
    assert ids.shape == (4 * len(chunks), BATCH // 2, make_schema(SPECS).num_slots)
    np.testing.assert_array_equal(ids[:steps], np.stack([b.ids for b in batches[:steps]]))
    np.testing.assert_array_equal(labels[:steps],
                                  np.stack([b.labels for b in batches[:steps]]))
    assert (weights[:steps] == 1).all() and (weights[steps:] == 0).all()
    assert (ids[steps:] == make_schema(SPECS).pad_id).all() and not labels[steps:].any()
