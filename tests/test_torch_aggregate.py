"""tpq_torch's aggregate on the CPU, where the kernels run their plain
versions: the sort path's run-end pass (kernels/aggregate.py) and the
hash path's group table (kernels/group_table.py), each held to numpy's
groups (np.unique, uint64 sums) over the whole capacity, the zero rows
past the groups included, on the cases of tests/torch_aggregate_cases.py;
the two paths of the aggregate held to each other. No tpq call:
tests/test_torch_pipeline.py holds the whole aggregate to tpq's. Integer
data: every comparison is exact."""

import numpy as np
import pytest
import torch
import torch_aggregate_cases as cases

from tpq_torch.columnar import Table, next_pow2
from tpq_torch.kernels import _build, aggregate, group_table, move, radix_partition
from tpq_torch.kernels.aggregate import aggregate_runs, aggregate_runs_ref
from tpq_torch.kernels.group_table import (group_insert, group_insert_ref, group_write,
                                           group_write_ref)
from tpq_torch.ops.hash_aggregate import hash_aggregate, sort_aggregate

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


def _run_buffer(nvals, n, stream=-1):
    return _build.stream_state(aggregate.state_owner(nvals), torch.device("cpu"), stream,
                               aggregate.state_words(n, nvals) + move.STATE_HEADER,
                               torch.int64)


def _pack_buffer(items, stream=-1):
    return _build.stream_state(move.PACK_OWNER, torch.device("cpu"), stream,
                               items + move.STATE_HEADER, torch.int64)


def test_aggregate_state_is_its_own_per_width():
    """The run-end pass's look-back state is a buffer apart from PACK's
    and the walk/emit's on the same device and stream, one a value-column
    count: its records' payloads hold raw counts and sums, which must
    never lie where another launch reads a status word. Each is made
    zero, kept across calls and replaced by a larger zeroed one when a
    call needs more room."""
    cpu = torch.device("cpu")
    _build.take_stream_state(cpu, -1)
    try:
        packs = _pack_buffer(10)
        one, three = _run_buffer(1, 5000), _run_buffer(3, 5000)
        assert len({packs.data_ptr(), one.data_ptr(), three.data_ptr()}) == 3
        assert _run_buffer(3, 5000) is three and not three.any()
        assert three.numel() >= aggregate.state_words(5000, 3) + move.STATE_HEADER
        big = _run_buffer(3, 1 << 22)
        assert big is not three and not big.any()
        assert big.numel() >= aggregate.state_words(1 << 22, 3) + move.STATE_HEADER
        assert _pack_buffer(10) is packs
    finally:
        _build.take_stream_state(cpu, -1)


def test_take_stream_state_takes_every_owner_of_one_stream():
    """A graph captured on a stream takes every kernel's buffer of that
    stream: PACK's (shared with the walk/emit), the run-end pass's of
    each width and the histogram's int32 accumulator all come back, and
    leave the registry, while another stream's stay."""
    cpu = torch.device("cpu")
    for s in (-1, -2):
        _build.take_stream_state(cpu, s)
    try:
        mine = [_pack_buffer(10), _run_buffer(1, 5000), _run_buffer(3, 5000),
                _build.stream_state(radix_partition.HIST_OWNER, cpu, -1, 65, torch.int32)]
        assert mine[-1].dtype == torch.int32 and not mine[-1].any()
        other = _pack_buffer(10, stream=-2)
        taken = _build.take_stream_state(cpu, -1)
        assert sorted(map(id, taken)) == sorted(map(id, mine))
        assert _build.take_stream_state(cpu, -1) == []
        assert _pack_buffer(10) is not mine[0]  # a new one, zeroed
        assert _pack_buffer(10, stream=-2) is other
    finally:
        for s in (-1, -2):
            _build.take_stream_state(cpu, s)


def _table(key, values, num_rows) -> Table:
    cols = {"key": torch.from_numpy(key)}
    cols.update((f"v{i}", torch.from_numpy(v)) for i, v in enumerate(values))
    return Table(cols, num_rows)


def _cols_equal(got, want) -> None:
    assert [c.dtype for c in got] == [torch.from_numpy(w).dtype for w in want]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", cases.CASES)
def test_group_table_plain_matches_numpy_and_the_sort_path(name):
    """The hash path's plain twins (group_insert_ref, then group_write_ref)
    on each case's rows in random order: `ok`, the group count and every
    output column byte-equal to numpy's over the whole capacity (zeros
    from the group count on) and to the sort path's (sort_aggregate), with
    num_rows an int32 and an int64 tensor; hash_aggregate's whole table
    equal to sort_aggregate's. Cases: 0, 1, all and more than all rows
    live, one key for every row, INT64_MAX and INT64_MIN keys, int32 keys
    and values, wrapping sums, 0, 1, 14 and 15 value columns. Past
    MAX_VALUES columns group_insert refuses the table (hash_aggregate
    takes the sort path there) and the twins are held alone."""
    key, values, num_rows = cases.hash_case(name)
    want, g = cases.np_groups(key, values, num_rows)
    k, vs = torch.from_numpy(key), [torch.from_numpy(v) for v in values]
    wide = len(vs) > group_table.MAX_VALUES
    if wide:
        with pytest.raises(ValueError, match="MAX_VALUES"):
            group_insert(k, vs, num_rows)
    for dt in (torch.int32, torch.int64):
        table = (group_insert_ref if wide else group_insert)(
            k, vs, torch.tensor(num_rows, dtype=dt))
        assert table.ok.dtype == torch.bool and bool(table.ok)
        assert table.slots == 2 * next_pow2(len(key)) and int(table.inserted) == g
        outs, groups = group_write(table)
        assert groups.dtype == torch.int32 and int(groups) == g
        _cols_equal(outs, want)
    t = _table(key, values, num_rows)
    by_hash, by_sort = hash_aggregate(t), sort_aggregate(t)
    assert int(by_hash.num_rows) == int(by_sort.num_rows) == g
    assert list(by_hash.columns) == list(by_sort.columns)
    _cols_equal(list(by_sort.columns.values()), want)
    _cols_equal(list(by_hash.columns.values()), want)


@pytest.mark.parametrize("past", [0, 1])
def test_group_table_limit_is_distinct_keys(monkeypatch, past):
    """MAX_SLOTS 64 (limit 32) under 3,000 rows of 32 distinct keys, or
    33 (INT64_MAX, in its own slot, among them): `ok` is distinct keys <=
    32, whatever the rows, and hash_aggregate's table is the sort path's
    either way (past the limit the cond takes the sort path)."""
    monkeypatch.setattr(group_table, "MAX_SLOTS", 64)
    rng = np.random.default_rng(64 + past)
    domain = np.concatenate([rng.choice(1 << 40, 31, replace=False) - (1 << 39),
                             np.array([np.iinfo(np.int64).max] + [-7] * past, np.int64)])
    assert domain.dtype == np.int64 and domain.max() == np.iinfo(np.int64).max
    n, live = 4000, 3000
    key = rng.choice(domain, n)
    key[:len(domain)] = domain  # every key live
    values = [rng.integers(0, 1 << 62, n), rng.integers(-9, 9, n).astype(np.int32)]
    table = group_insert(torch.from_numpy(key), [torch.from_numpy(v) for v in values], live)
    assert table.slots == 64 and table.limit == 32
    assert int(table.inserted) == 32 + past and bool(table.ok) == (not past)
    t = _table(key, values, live)
    want, g = cases.np_groups(key, values, live)
    assert g == 32 + past
    _cols_equal(list(hash_aggregate(t).columns.values()), want)
    _cols_equal(list(sort_aggregate(t).columns.values()), want)


def test_group_table_takes_a_host_count_and_raises_off_cpu_and_cuda():
    """num_rows as a Python int is the same call; the columns must be 1-D
    int32 or int64 of one length; a table sizes itself from the
    capacity, at most MAX_SLOTS slots."""
    key, values, num_rows = cases.hash_case("int32")
    k, vs = torch.from_numpy(key), [torch.from_numpy(v) for v in values]
    a, ga = group_write(group_insert(k, vs, num_rows))
    b, gb = group_write_ref(group_insert_ref(k, vs, torch.tensor(num_rows)))
    assert int(ga) == int(gb)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        group_insert(k, [vs[0][:-1]], num_rows)
    with pytest.raises(TypeError):
        group_insert(k, [vs[0].to(torch.float32)], num_rows)
    with pytest.raises(RuntimeError, match="no kernel"):
        group_insert(k.to("meta"), [], num_rows)
    assert group_table.table_slots(1 << 12) == 1 << 13
    assert group_table.table_slots(1 << 27) == group_table.MAX_SLOTS == 1 << 21
