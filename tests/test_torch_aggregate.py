"""tpq_torch's aggregate run-end pass (kernels/aggregate.py) on the CPU,
where `aggregate_runs` runs its plain version: held to numpy's groups
(np.unique's runs, uint64 sums) over the whole capacity, the zero rows
past the groups included, on the cases of tests/torch_aggregate_cases.py.
No tpq call: tests/test_torch_pipeline.py holds the whole aggregate to
tpq's. Integer data: every comparison is exact."""

import numpy as np
import pytest
import torch
import torch_aggregate_cases as cases

from tpq_torch.kernels import aggregate, move
from tpq_torch.kernels.aggregate import aggregate_runs, aggregate_runs_ref

torch.set_num_threads(2)


@pytest.mark.parametrize("name", cases.CASES)
def test_aggregate_runs_plain_matches_numpy(name):
    """Every output column byte-equal to numpy's over the whole capacity
    (zeros from the group count on) and G equal to numpy's, with
    num_rows an int32 and an int64 tensor; a second call gives the same
    bytes."""
    key, values, num_rows = cases.agg_case(name)
    want, g = cases.np_aggregate(key, values, num_rows)
    k, vs = torch.from_numpy(key), [torch.from_numpy(v) for v in values]
    for dt in (torch.int32, torch.int64):
        nr = torch.tensor(num_rows, dtype=dt)
        outs, groups = aggregate_runs(k, vs, nr)
        again, groups2 = aggregate_runs(k, vs, nr)
        assert groups.dtype == torch.int32 and int(groups) == int(groups2) == g
        assert [o.dtype for o in outs] == [k.dtype] + [torch.int64] * (1 + len(vs))
        for got, second, w in zip(outs, again, want):
            assert np.array_equal(got.numpy(), w)
            assert torch.equal(got, second)


def test_aggregate_runs_takes_a_host_count_and_raises_off_cpu_and_cuda():
    """num_rows as a Python int is the same call; the columns must be 1-D
    int32 or int64 of one length."""
    key, values, num_rows = cases.agg_case("int32")
    k, vs = torch.from_numpy(key), [torch.from_numpy(v) for v in values]
    a, ga = aggregate_runs(k, vs, num_rows)
    b, gb = aggregate_runs_ref(k, vs, torch.tensor(num_rows))
    assert int(ga) == int(gb)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        aggregate_runs(k, [vs[0][:-1]], num_rows)
    with pytest.raises(TypeError):
        aggregate_runs(k, [vs[0].to(torch.float32)], num_rows)
    with pytest.raises(RuntimeError, match="no kernel"):
        aggregate_runs(k.to("meta"), [], num_rows)


def test_aggregate_state_is_its_own_per_width():
    """The run-end pass's look-back state is a buffer apart from PACK's
    and the walk/emit's on the same device and stream, one a value-column
    count: its records' payloads hold raw counts and sums, which must
    never lie where another launch reads a status word. Each is made
    zero, kept across calls and replaced by a larger zeroed one when a
    call needs more room."""
    cpu, s = torch.device("cpu"), -1
    keys = [(None, s)] + [(None, s, nv) for nv in (1, 3)]
    for k in keys:
        (move._PACK_STATE if len(k) == 2 else aggregate._AGG_STATE).pop(k, None)
    try:
        packs = move._pack_state(cpu, s, 10)
        one, three = aggregate._agg_state(cpu, s, 1, 5000), aggregate._agg_state(cpu, s, 3, 5000)
        assert len({packs.data_ptr(), one.data_ptr(), three.data_ptr()}) == 3
        assert aggregate._agg_state(cpu, s, 3, 5000) is three and not three.any()
        assert three.numel() >= aggregate.state_words(5000, 3) + move.STATE_HEADER
        big = aggregate._agg_state(cpu, s, 3, 1 << 22)
        assert big is not three and not big.any()
        assert big.numel() >= aggregate.state_words(1 << 22, 3) + move.STATE_HEADER
        assert move._pack_state(cpu, s, 10) is packs
    finally:
        for k in keys:
            (move._PACK_STATE if len(k) == 2 else aggregate._AGG_STATE).pop(k, None)
