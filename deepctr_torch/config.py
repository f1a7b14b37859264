"""Config system: dataclass configs + JSON files + CLI overrides.

Copy of ``deepctr_tpu/config.py``. The port imports nothing of the JAX
package, so it keeps this copy; its behaviour is meant to be
identical, and ``tests/test_torch_data.py`` holds it to the original.

Reference parity: the reference's "config system" is module-level constants
edited in-file (SURVEY.md §1 entry layer, §5 config row).  Here every run is
described by a serialisable ``RunConfig``; the bundled ``configs/*.json``
mirror the BASELINE.json:6-12 config list (lr/ipinyou, fm/k10,
fnn/full-ipinyou, snn/multichip, criteo-sharded stretch).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class ModelConfig:
    name: str = "fnn"                  # lr | fm | fnn | snn | deepfm
    k: int = 10                        # FM/FNN latent factors
    hidden: tuple[int, ...] = (200, 300, 100)
    activation: str = "tanh"
    dropout: float = 0.5
    hidden1: int = 200                 # SNN bottom layer width
    init_sigma: float = 0.01
    use_pallas: bool = False           # fused TPU kernels (FM scorer, tower)
    init_from: str | None = None       # checkpoint path: FM table (fnn) or
                                       # DAE/RBM pretrain output (snn)


@dataclasses.dataclass
class OptimConfig:
    sparse: str = "adagrad"            # sgd | adagrad
    sparse_lr: float = 0.05
    # adagrad execution strategy (optim/sparse.py): "dense" scatter-adds into
    # a [V, D] scratch; "sorted" runs the vocab-independent segmented-scan
    # path (Criteo-scale hash spaces); "auto" picks by table size
    sparse_mode: str = "auto"          # auto | dense | sorted
    eps: float = 1e-6                  # adagrad denominator epsilon
    dense: str = "adagrad"             # any optax alias: sgd | adagrad | adam
    dense_lr: float = 0.02
    l2: float = 0.0


@dataclasses.dataclass
class DataConfig:
    format: str = "yx"                 # yx | criteo (raw TSV, hash trick)
    train_path: str | None = None      # text file (None -> synthetic)
    test_path: str | None = None
    schema_path: str | None = None     # Schema JSON (None -> ipinyou_like,
                                       # or criteo_schema for format=criteo)
    featindex_path: str | None = None  # make-ipinyou-data featindex.txt:
                                       # derives the schema AND remaps yx ids
                                       # (real-iPinYou on-ramp, format=yx)
    featindex_max_len: str = "usertag=3"  # multi-valued fields, "name=N,..."
    criteo_cat_buckets: int = 1_000_000  # hash buckets per categorical column
    synthetic_examples: int = 200_000
    synthetic_seed: int = 0
    # planted process for synthetic data (data/synthetic.py): "fm" anchors
    # parity to the reference reproduction; "mlp" plants higher-order
    # structure so the paper's deep>shallow ordering is demonstrable
    synthetic_teacher: str = "fm"      # fm | mlp | ortho
    test_fraction: float = 0.15        # used when test_path is None
    use_cache: bool = True
    use_native_parser: bool = True
    # streaming ingestion (data/stream.py): train WITHOUT materializing the
    # dataset — shard files (train_path may be a glob/comma list) parsed
    # chunk-by-chunk through the native parser into a shuffle buffer; host
    # RAM is bounded by stream_buffer_rows + one chunk.  Requires test_path
    # (eval set stays in RAM).  The Criteo-scale path (BASELINE.json:11).
    stream: bool = False
    stream_buffer_rows: int = 262_144


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 4096
    epochs: int = 10
    seed: int = 0
    early_stop_patience: int = 2
    lr_decay: float = 1.0     # per-epoch multiplicative LR decay
    scan_steps: int = 8       # minibatch steps fused per dispatch (0 = off)
    prefetch: bool = True
    # small fields (vocab <= threshold) run as one-hot MXU matmuls with dense
    # per-field gradients instead of gather/scatter rows (ops/split_embed.py);
    # 0 disables the split path entirely
    split_threshold: int = 8192
    # embedding-table storage dtype: "bf16" halves gather + full-table
    # elementwise HBM traffic (math stays f32; BENCH.md roofline knob)
    table_dtype: str = "f32"           # f32 | bf16
    # SNN pretraining phase
    pretrain: str | None = None        # dae | rbm | None
    pretrain_epochs: int = 1
    pretrain_m: int = 2
    pretrain_corruption: float = 0.3
    pretrain_lr: float = 0.1
    # parallelism
    sharded: bool = False              # row-sharded tables + all-to-all
    num_devices: int | None = None     # None -> all
    capacity_factor: float = 2.0
    # wire dtype of the row/grad all_to_all payload: "bf16" halves the
    # dominant cross-host exchange volume for ~2^-8 relative rounding
    # (math stays f32; see SCALING.md and parallel/comm.py)
    exchange_dtype: str = "f32"        # f32 | bf16
    # io / fault tolerance (SURVEY.md §5: heartbeat + restart-from-checkpoint)
    resume: bool = False               # resume from checkpoint_path if present
    checkpoint_every: int = 1          # save every N epochs (when path set)
    checkpoint_path: str | None = None
    metrics_path: str | None = None
    profile_dir: str | None = None
    # debugging / multi-host
    debug_nans: bool = False           # jax_debug_nans (sanitizer row, §5)
    distributed: bool = False          # jax.distributed.initialize() for
                                       # multi-host DCN meshes (no-op 1-host)


@dataclasses.dataclass
class RunConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    # ---- serialisation ----------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_dict(raw: dict[str, Any]) -> "RunConfig":
        def build(cls, d):
            if d is None:
                return cls()
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kw = {}
            for key, val in d.items():
                if key not in fields:
                    raise ValueError(f"unknown config key {cls.__name__}.{key}")
                if isinstance(val, list):
                    val = tuple(val)
                kw[key] = val
            return cls(**kw)

        return RunConfig(
            model=build(ModelConfig, raw.get("model")),
            optim=build(OptimConfig, raw.get("optim")),
            data=build(DataConfig, raw.get("data")),
            train=build(TrainConfig, raw.get("train")),
        )

    @staticmethod
    def from_json(text: str) -> "RunConfig":
        return RunConfig.from_dict(json.loads(text))

    @staticmethod
    def load(path: str) -> "RunConfig":
        with open(path) as f:
            return RunConfig.from_json(f.read())

    def apply_overrides(self, overrides: list[str]) -> "RunConfig":
        """Apply dotted CLI overrides like ``train.batch_size=1024``."""
        raw = dataclasses.asdict(self)
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override {ov!r} is not key=value")
            key, val = ov.split("=", 1)
            parts = key.split(".")
            node = raw
            for p in parts[:-1]:
                if p not in node:
                    raise ValueError(f"unknown config section {p!r}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise ValueError(f"unknown config key {key!r}")
            node[leaf] = _parse_value(val, node[leaf])
        return RunConfig.from_dict(raw)


def _parse_value(text: str, current: Any) -> Any:
    if isinstance(current, bool):
        return text.lower() in ("1", "true", "yes")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(text)
    if isinstance(current, float):
        return float(text)
    if isinstance(current, (list, tuple)):
        return tuple(int(x) if x.strip().isdigit() else x.strip()
                     for x in text.strip("()[]").split(",") if x.strip())
    if current is None or isinstance(current, str):
        # optional fields: "none"/"null" reset to None even after having
        # been set to a string; otherwise try numeric literals, else string
        if text.lower() in ("none", "null"):
            return None
        if current is None:
            for cast in (int, float):
                try:
                    return cast(text)
                except ValueError:
                    pass
        return text
    return text
