"""tpq_torch's lane hash join held against tpq's: the plan, the build,
the fused walk/emit (fed identical tables) and the whole join, at the
lane-case0 shape of tests/test_ops_oracle.py. tpq runs once, in a
module fixture (interpret-mode Pallas); the port runs its plain torch
kernel versions. Integer data: every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

from tpq import Table as JTable
from tpq import datagen as jdatagen
from tpq.columnar import canonicalize as jcanonicalize
from tpq.config import PRESETS as JPRESETS
from tpq.kernels import lane2 as jlane2
from tpq.ops import hash_join as jhash_join
from tpq_torch import Table
from tpq_torch.bench.runner import out_capacity_for
from tpq_torch.columnar import canonicalize
from tpq_torch.config import PRESETS
from tpq_torch.kernels.lane2 import (build_lane2_tables, fused_probe_emit2,
                                     lane2_path_taken, plan_lane2)
from tpq_torch.kernels.lane_table import LanePlan, lane_tables_from_numpy
from tpq_torch.ops import hash_join
from tpq_torch.ops.union_join import col_planes

from conftest import assert_tables_equal

torch.set_num_threads(2)

# the lane-case0 shape of tests/test_ops_oracle.py
R_NP = jdatagen.gen_relation_np(1000, 300, payloads=2, seed=11)
S_NP = jdatagen.gen_relation_np(1500, 300, payloads=1, seed=22)
CAP = 1 << 14


def _i64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """tpq's (lo, hi) 32-bit planes -> int64."""
    return ((hi.astype(np.uint32).astype(np.uint64) << np.uint64(32))
            | lo.astype(np.uint32).astype(np.uint64)).view(np.int64)


@pytest.fixture(scope="module")
def tpq_lane():
    """tpq's build, fused walk/emit and lane join on the case, run once."""
    R, S = JTable.from_numpy(R_NP), JTable.from_numpy(S_NP)
    plan = jlane2.plan_lane2(R.capacity, S.capacity, out_capacity=CAP)
    tables = jlane2.build_lane2_tables(R, plan)
    out_planes, cnt, d_first, *_ = jlane2.fused_probe_emit2(tables, S, CAP)
    join = jhash_join(R, S, CAP, impl="lane")
    return {
        "plan": LanePlan(*dataclasses.astuple(plan)),
        "key_planes": [np.asarray(x) for x in tables.key_planes],
        "pay_planes": [np.asarray(x) for x in tables.pay_planes],
        "occ": np.asarray(tables.occ),
        "ok": bool(tables.ok),
        "out_planes": [np.asarray(x) for x in out_planes],
        "cnt": np.asarray(cnt),
        "d_first": np.asarray(d_first),
        "join": jcanonicalize(join),
    }


@pytest.mark.parametrize("preset", ["smoke_1k", "single_chip_1m",
                                    "build_sweep_10m_100m"])
def test_plan_matches_tpq(preset):
    cfg, jcfg = PRESETS[preset], JPRESETS[preset]
    out_cap = out_capacity_for(cfg)
    got = plan_lane2(cfg.r.capacity(), cfg.s.capacity(), out_capacity=out_cap)
    want = jlane2.plan_lane2(jcfg.r.capacity(), jcfg.s.capacity(),
                             out_capacity=out_cap)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    if preset == "single_chip_1m":
        assert out_cap == 4_194_304
        assert (got.npart, got.pbits, got.depth, got.probe_cap, got.inline_k,
                got.tail_rows_cap, got.tail_out_cap) == (
                    512, 9, 48, 3072, 4, 12_288, 6_144)
        assert got.npart * got.probe_cap == 1_572_864


def test_build_matches_tpq(tpq_lane):
    r = Table.from_numpy(R_NP)
    plan = plan_lane2(r.capacity, 2048, out_capacity=CAP)
    assert plan == tpq_lane["plan"]
    t = build_lane2_tables(r, plan)
    occ = tpq_lane["occ"]
    np.testing.assert_array_equal(t.occ.numpy(), occ)
    np.testing.assert_array_equal(t.blen.numpy(), occ.sum(1))
    assert bool(t.ok) == tpq_lane["ok"]
    live = occ.astype(bool)
    ours = [p for c in [t.key, *t.pays] for p in col_planes(c)]
    theirs = tpq_lane["key_planes"] + tpq_lane["pay_planes"]
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy()[live], b.view(np.int32)[live])


def test_fused_walk_emit_on_tpq_tables(tpq_lane):
    tables = lane_tables_from_numpy(tpq_lane["plan"], tpq_lane["key_planes"],
                                    tpq_lane["pay_planes"], tpq_lane["occ"],
                                    tpq_lane["ok"])
    outs, cnt, d_first, _, _, qocc, _, ovf = fused_probe_emit2(
        tables, Table.from_numpy(S_NP), CAP)
    assert not bool(ovf)
    np.testing.assert_array_equal(cnt.numpy(), tpq_lane["cnt"])
    np.testing.assert_array_equal(d_first.numpy(), tpq_lane["d_first"])
    K = tables.plan.inline_k
    cnt_eff = np.where(qocc.numpy() > 0, tpq_lane["cnt"], 0)
    assert (cnt_eff > K).any()  # the case reaches the tail
    n = int(np.minimum(cnt_eff, K).sum())
    jp = tpq_lane["out_planes"]
    names = ["key", "r_p0", "r_p1", "s_p0"]
    theirs = JTable({nm: _i64(jp[2 * i], jp[2 * i + 1])[:n]
                     for i, nm in enumerate(names)}, n)
    ours = Table({nm: o[:n] for nm, o in zip(names, outs)}, n)
    assert_tables_equal(canonicalize(ours), jcanonicalize(theirs), "inline rows")


def test_port_build_walks_like_tpq_build(tpq_lane):
    """The port's own tables give the fused kernel the same results as
    tpq's tables passed across."""
    plan = tpq_lane["plan"]
    s = Table.from_numpy(S_NP)
    mine = fused_probe_emit2(build_lane2_tables(Table.from_numpy(R_NP), plan),
                             s, CAP)
    across = fused_probe_emit2(
        lane_tables_from_numpy(plan, tpq_lane["key_planes"],
                               tpq_lane["pay_planes"], tpq_lane["occ"],
                               tpq_lane["ok"]), s, CAP)
    for a, b in zip(mine[:3], across[:3]):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y)


def test_hash_join_lane_matches_tpq(tpq_lane):
    r, s = Table.from_numpy(R_NP), Table.from_numpy(S_NP)
    assert bool(lane2_path_taken(r, s, CAP))
    out = hash_join(r, s, CAP, impl="lane")
    assert_tables_equal(canonicalize(out), tpq_lane["join"], "lane join")
