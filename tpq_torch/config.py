"""Engine and benchmark configuration (port of tpq/config.py).

The named presets are tpq's, field for field; the bench runner
(tpq_torch/bench/runner.py) consumes them. tpq's JoinConfig fields that
nothing reads (partition_bits, vmem_budget_bytes, table_load_factor,
max_displacement) are left out; `sort_engine` names the engine of
merge_join (tpq's runner always takes its default, lax).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class RelationSpec:
    rows: int
    nkeys: int
    payloads: int = 1
    seed: int = 0
    kind: str = "uniform"  # uniform | zipf
    theta: float = 1.0

    def capacity(self) -> int:
        from tpq_torch.columnar import next_pow2

        return next_pow2(self.rows)


@dataclass(frozen=True)
class JoinConfig:
    """Hash-join planning knobs."""

    algo: str = "hash"  # hash | merge
    impl: str = "lane"  # lane | sorted | skew
    sort_engine: str = "lax"  # merge_join's engine: lax | radix
    out_capacity_factor: float = 4.0  # x max(|R|,|S|) static output slack


@dataclass(frozen=True)
class BenchConfig:
    name: str
    r: RelationSpec
    s: RelationSpec
    join: JoinConfig = field(default_factory=JoinConfig)
    pipeline: bool = False  # config 4: filter -> join -> aggregate
    filter_value: int | None = None  # pipeline filter: key < value
    warmup: int = 1
    iters: int = 5
    mesh_shape: tuple[int, ...] = ()  # () = single chip; config 5 sets this


def _c(name, **kw) -> BenchConfig:
    return BenchConfig(name=name, **kw)


PRESETS: dict[str, BenchConfig] = {}


def _register(cfg: BenchConfig) -> BenchConfig:
    PRESETS[cfg.name] = cfg
    return cfg


# config 1 — single-chip equi-join, uniform int64, 1M x 1M, 1 payload col
_register(_c(
    "single_chip_1m",
    r=RelationSpec(rows=1 << 20, nkeys=1 << 20, payloads=1, seed=1),
    s=RelationSpec(rows=1 << 20, nkeys=1 << 20, payloads=1, seed=2),
))

# config 2 — build-side scaling sweep 10M x 100M, 4 payload cols
_register(_c(
    "build_sweep_10m_100m",
    r=RelationSpec(rows=10_000_000, nkeys=10_000_000, payloads=4, seed=1),
    s=RelationSpec(rows=100_000_000, nkeys=10_000_000, payloads=4, seed=2),
    join=JoinConfig(out_capacity_factor=2.0),
))

# config 3 — zipf theta=1.0 skew on the PROBE side vs a uniform build
# (a zipf x zipf pair at this size joins to ~8e9 rows, see tpq/config.py)
_register(_c(
    "zipf_skew",
    r=RelationSpec(rows=1 << 20, nkeys=1 << 20, payloads=1, seed=1),
    s=RelationSpec(rows=1 << 20, nkeys=1 << 20, payloads=1, seed=2, kind="zipf"),
    join=JoinConfig(impl="skew", out_capacity_factor=4.0),
))

# config 4 — full pipeline: filter -> hash join -> hash aggregate, 100M fact
_register(_c(
    "pipeline_100m",
    r=RelationSpec(rows=1 << 20, nkeys=1 << 20, payloads=1, seed=1),  # dim
    s=RelationSpec(rows=100_000_000, nkeys=1 << 20, payloads=2, seed=2),  # fact
    pipeline=True,
    filter_value=1 << 19,
    join=JoinConfig(out_capacity_factor=1.0),
))

# config 5 — distributed join, 1B x 1B (mesh shape set by the caller)
_register(_c(
    "dist_1b",
    r=RelationSpec(rows=1_000_000_000, nkeys=1_000_000_000, payloads=1, seed=1),
    s=RelationSpec(rows=1_000_000_000, nkeys=1_000_000_000, payloads=1, seed=2),
    mesh_shape=(8,),
))

# config 5 cut to one of its eight hosts' share: R and S at 125M rows and
# nkeys 125M (1B / 8), shapes unchanged (int64 key, one int64 payload,
# uniform keys, rows/nkeys = 1); all eight shards held on one card
_register(replace(PRESETS["dist_1b"], name="dist_125m_8shard",
                  r=RelationSpec(rows=125_000_000, nkeys=125_000_000, payloads=1, seed=1),
                  s=RelationSpec(rows=125_000_000, nkeys=125_000_000, payloads=1, seed=2)))

# smoke-scale twins (1/1000 scale)
_register(replace(PRESETS["single_chip_1m"], name="smoke_1k",
                  r=RelationSpec(rows=1024, nkeys=1024, seed=1),
                  s=RelationSpec(rows=1024, nkeys=1024, seed=2)))
_register(replace(PRESETS["pipeline_100m"], name="smoke_pipeline",
                  r=RelationSpec(rows=1024, nkeys=1024, seed=1),
                  s=RelationSpec(rows=100_000, nkeys=1024, payloads=2, seed=2),
                  filter_value=512))
