"""The port's ``simstep``: its plain versions against the JAX reference and
the Pallas kernel (interpret mode), the ragged level 2 against JAX
``vm_level_rates`` on ragged and skewed states, the row index, and the
CPU dispatch.  The CUDA kernel itself is tested in ``test_torch_cuda.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_simstep_parity import _random_tile

from repro.core import scheduling as JSCH
from repro.core import state as JS
from repro.core.provisioning import provision_pending as j_provision
from repro.kernels.simstep import simstep_pallas as j_pallas
from repro.kernels.simstep import simstep_ref as j_ref
from repro_torch.core import scheduling
from repro_torch.core.convert import from_arrays
from repro_torch.core.state import validate_cloudlet_order
from repro_torch.kernels.simstep import (CHUNK, WINDOW, row_index, simstep,
                                         simstep_ragged, simstep_ragged_ref,
                                         simstep_ref)

INF = 1e30


def _torch_tile(tile, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in tile]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("v,k", [(8, 16), (13, 8), (3, 128), (32, 4)])
@pytest.mark.parametrize("policy", [0, 1])
def test_ref_matches_jax_ref_and_pallas(seed, v, k, policy):
    tile = _random_tile(seed, v, k, all_idle_rows=1, zero_cap_rows=1,
                        big_pes_rows=1)
    r, d = simstep_ref(*_torch_tile(tile), policy)
    r_ref, d_ref = j_ref(*tile, policy)
    r_pal, d_pal = j_pallas(*tile, policy, interpret=True)
    for want_r, want_d in ((r_ref, d_ref), (r_pal, d_pal)):
        np.testing.assert_allclose(r.numpy(), np.asarray(want_r),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(d.numpy(), np.asarray(want_d), rtol=1e-6)


def test_ref_edge_cases():
    """All idle, pes > K, zero capacity, drained slots — as the JAX
    parity suite pins them."""
    r, d = simstep_ref(torch.full((9, 8), 100.0), torch.zeros(9, 8,
                                                              dtype=bool),
                       torch.full((9,), 500.0), torch.ones(9), 1)
    assert torch.all(r == 0.0) and torch.all(d >= INF * 0.99)
    rem, run = torch.full((4, 4), 1000.0), torch.ones(4, 4, dtype=bool)
    for policy in (0, 1):
        r, _ = simstep_ref(rem, run, torch.full((4,), 800.0),
                           torch.full((4,), 8.0), policy)
        np.testing.assert_allclose(r.numpy(), 100.0, rtol=1e-6)
    r, d = simstep_ref(torch.tensor([[0.0, 100.0, 0.0, 50.0]]),
                       torch.ones(1, 4, dtype=bool), torch.tensor([100.0]),
                       torch.tensor([2.0]), 0)
    np.testing.assert_allclose(r.numpy(), [[0.0, 50.0, 0.0, 50.0]])
    np.testing.assert_allclose(d.numpy(), [1.0])
    r, d = simstep_ref(torch.zeros(3, 0), torch.zeros(3, 0, dtype=bool),
                       torch.ones(3), torch.ones(3), 0)
    assert r.shape == (3, 0) and torch.all(d == np.float32(INF))


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    tile = _torch_tile(_random_tile(0, 8, 16))
    rem, run, cap, pes = tile
    index = row_index(torch.arange(8, dtype=torch.int32)
                      .repeat_interleave(16), 8)
    before = simstep.launches
    for policy in (0, torch.tensor(1, dtype=torch.int32)):
        got = simstep(*tile, policy)
        want = simstep_ref(*tile, policy)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        got = simstep_ragged(rem.reshape(-1), run.reshape(-1), index, cap,
                             pes, policy)
        want = simstep_ragged_ref(rem.reshape(-1), run.reshape(-1), index,
                                  cap, pes, policy)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert simstep.launches == before


def _ragged_state(seed, vm_policy, task_policy):
    """Uneven cloudlets per VM, VMs without cloudlets, ``vm = -1`` padding
    slots, drained and finished slots; provisioned by the JAX package."""
    rng = np.random.default_rng(seed)
    nv = int(rng.integers(3, 9))
    counts = rng.integers(0, 6, nv)
    counts[rng.integers(0, nv)] = 0
    owners = []
    for vm, c in enumerate(counts):
        owners += [vm] * int(c)
        if rng.uniform() < 0.4:
            owners += [-1] * int(rng.integers(1, 3))
    owners = np.asarray(owners + [-1], np.int32)
    nc = owners.shape[0]
    hosts = JS.make_hosts(rng.integers(1, 4, 3), [500.0, 1000.0, 1000.0],
                          4096.0, 1000.0, 1e6)
    vms = JS.make_vms(rng.integers(1, 4, nv), 500.0, 64.0, 1.0, 10.0)
    cl = JS.make_cloudlets(owners, rng.uniform(100, 900, nc).astype(
        np.float32), np.round(rng.uniform(0, 2, nc), 1).astype(np.float32))
    remaining = np.asarray(cl.remaining).copy()
    remaining[rng.uniform(size=nc) < 0.15] = 0.0
    state = np.asarray(cl.state).copy()
    state[rng.uniform(size=nc) < 0.1] = JS.CL_DONE
    cl = dataclasses.replace(cl, remaining=jnp.asarray(remaining),
                             state=jnp.asarray(state))
    dc = JS.make_datacenter(hosts, vms, cl, vm_policy=vm_policy,
                            task_policy=task_policy,
                            reserve_pes=bool(seed % 2))
    dc = j_provision(dc)
    return dataclasses.replace(dc, time=jnp.float32(1.0))


@pytest.mark.parametrize("seed", range(8))
def test_gather_scatter_matches_jax_vm_level_rates(seed):
    for vp, tp in ((0, 0), (0, 1), (1, 0), (1, 1)):
        jdc = _ragged_state(seed, vp, tp)
        runnable = JSCH.cloudlet_runnable(jdc)
        active = jdc.vms.state == JS.VM_ACTIVE
        eligible = jnp.where(jdc.reserve_pes == 1, active,
                             active & JSCH.vm_has_work(jdc, runnable))
        vm_cap = JSCH.host_level_shares(jdc, eligible)
        want = np.asarray(JSCH.vm_level_rates(jdc, vm_cap, runnable))

        tdc = from_arrays(jdc, device="cpu")
        t_run = torch.from_numpy(np.array(runnable))
        t_cap = torch.from_numpy(np.array(vm_cap))
        got = scheduling.vm_level_rates(tdc, t_cap, t_run)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   err_msg=str((seed, vp, tp)))
        # the kernel's per-row minimum is the flat event-queue head
        rates, dt = scheduling.rates_and_dt(tdc)
        rem = np.asarray(jdc.cloudlets.remaining)
        fdt = np.where(want > 0, rem / np.maximum(want, np.float32(1e-30)),
                       np.float32(INF)).astype(np.float32)
        np.testing.assert_allclose(float(dt), float(fdt.min()), rtol=1e-6)


def _grouped_layout(rng, lengths, unowned=True):
    """i32[C] VM id per slot: the rows of ``lengths`` in a shuffled slot
    order, each one contiguous run, with runs of ``-1`` (slots that belong
    to no VM) between some of them."""
    vm = []
    for r in rng.permutation(len(lengths)):
        if unowned and rng.uniform() < 0.3:
            vm += [-1] * int(rng.integers(1, 4))
        vm += [int(r)] * int(lengths[r])
    return np.asarray(vm + [-1] * unowned, np.int32)


LAYOUTS = {  # row lengths
    "ragged": lambda rng: rng.integers(0, 12, int(rng.integers(3, 40))),
    "skewed": lambda rng: np.concatenate(
        [[int(rng.integers(150, 400))], rng.integers(0, 5, 60)]),
}


def _flat_inputs(seed, layout):
    """A grouped layout with drained slots, an all-idle VM, a zero-capacity
    VM and a VM with more PEs than slots; runnable implies remaining > 0
    and a VM, as ``scheduling.cloudlet_runnable`` gives."""
    rng = np.random.default_rng(seed)
    lengths = LAYOUTS[layout](rng)
    nv = lengths.size
    vm = _grouped_layout(rng, lengths)
    c = vm.size
    rem = rng.uniform(0.0, 5000.0, c).astype(np.float32)
    rem[rng.uniform(size=c) < 0.15] = 0.0
    run = (rng.uniform(size=c) < 0.7) & (rem > 0) & (vm >= 0)
    cap = rng.uniform(100.0, 2000.0, nv).astype(np.float32)
    pes = rng.integers(1, 4, nv).astype(np.float32)
    rows = rng.permutation(nv)
    run[vm == rows[0]] = False
    cap[rows[1]] = 0.0
    pes[rows[-1]] = lengths[rows[-1]] + rng.integers(1, 5)
    return vm, rem, run, cap, pes


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("seed", range(4))
def test_ragged_ref_matches_jax_vm_level_rates(seed, layout):
    """Rates against JAX ``vm_level_rates`` and dt_min against a per-VM
    min of remaining/rate, both policies, at test_simstep_parity's rtol."""
    vm, rem, run, cap, pes = _flat_inputs(seed, layout)
    nv = cap.size
    index = row_index(torch.from_numpy(vm), nv)
    for policy in (0, 1):
        jdc = JS.make_datacenter(
            JS.make_hosts([1], [1000.0], 1024.0, 1000.0, 1e6),
            JS.make_vms(pes.astype(np.int32), 1000.0, 64.0, 1.0, 10.0),
            JS.make_cloudlets(vm, rem), task_policy=policy)
        want = np.asarray(JSCH.vm_level_rates(jdc, jnp.asarray(cap),
                                              jnp.asarray(run)))
        dt = np.where(want > 0, rem / np.maximum(want, np.float32(1e-30)),
                      np.float32(INF)).astype(np.float32)
        want_dt = np.full(nv, np.float32(INF), np.float32)
        np.minimum.at(want_dt, vm[vm >= 0], dt[vm >= 0])

        rates, dt_min = simstep_ragged_ref(
            torch.from_numpy(rem), torch.from_numpy(run), index,
            torch.from_numpy(cap), torch.from_numpy(pes), policy)
        ctx = str((seed, layout, policy))
        np.testing.assert_allclose(rates.numpy(), want, rtol=1e-6,
                                   atol=1e-6, err_msg=ctx)
        np.testing.assert_allclose(dt_min.numpy(), want_dt, rtol=1e-6,
                                   err_msg=ctx)
        assert np.all(rates.numpy()[vm < 0] == 0.0), ctx


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("v,k", [(8, 16), (13, 8), (3, 128), (32, 4)])
def test_ragged_ref_on_uniform_rows_equals_dense_ref(seed, v, k):
    """Row v at slots v*K .. v*K+K-1: bitwise the dense plain version, and
    the Pallas kernel (interpret) at rtol 1e-6."""
    tile = _random_tile(seed, v, k, all_idle_rows=1, zero_cap_rows=1,
                        big_pes_rows=1)
    rem, run, cap, pes = _torch_tile(tile)
    index = row_index(torch.arange(v, dtype=torch.int32)
                      .repeat_interleave(k), v)
    for policy in (0, 1):
        r, d = simstep_ragged_ref(rem.reshape(-1), run.reshape(-1), index,
                                  cap, pes, policy)
        r_dense, d_dense = simstep_ref(rem, run, cap, pes, policy)
        assert torch.equal(r.view(v, k), r_dense)
        assert torch.equal(d, d_dense)
        r_pal, d_pal = j_pallas(*tile, policy, interpret=True)
        np.testing.assert_allclose(r.view(v, k).numpy(), np.asarray(r_pal),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(d.numpy(), np.asarray(d_pal), rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_row_index_round_trips(seed):
    """Each row is its VM's contiguous run; slots with a VM id outside
    [0, V) have no row; rows without slots are listed as empty."""
    rng = np.random.default_rng(seed)
    nv = 9
    lengths = rng.integers(0, 5, nv)
    lengths[rng.integers(0, nv)] = 0
    vm = _grouped_layout(rng, lengths)
    vm[vm == -1] = rng.choice([-1, nv, nv + 3], int((vm == -1).sum()))
    index = row_index(torch.from_numpy(vm), nv)
    slot_row = index.slot_row.numpy()
    np.testing.assert_array_equal(
        slot_row, np.where((vm >= 0) & (vm < nv), vm, -1))
    start, length = index.start.numpy(), index.length.numpy()
    np.testing.assert_array_equal(length, lengths)
    for r in range(nv):
        np.testing.assert_array_equal(np.nonzero(vm == r)[0],
                                      start[r] + np.arange(length[r]))
    np.testing.assert_array_equal(np.sort(index.empty.numpy()),
                                  np.nonzero(lengths == 0)[0])
    assert index.n_slots == vm.size and index.n_rows == nv


def test_row_index_cuts_long_rows_into_chunks():
    """A row is long above WINDOW slots; each long row's chunks are
    consecutive and cover it."""
    lengths = [0, 1, 31, 32, 33, 64, 65, 1024, 3000, 5]
    vm = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    index = row_index(torch.from_numpy(vm), len(lengths))
    length = index.length.numpy()
    long = length > WINDOW
    assert list(np.nonzero(long)[0]) == [4, 5, 6, 7, 8]
    want_rows = np.repeat(np.nonzero(long)[0],
                          (length[long] + CHUNK - 1) // CHUNK)
    np.testing.assert_array_equal(index.chunk_row.numpy(), want_rows)
    first = index.chunk_first.numpy()
    for c, r in enumerate(want_rows):
        assert first[c] == np.nonzero(want_rows == r)[0][0]


def _greedy_windows(slot_row):
    """The span starts of ``RowIndex.window``, one span at a time: from each
    boundary, the last boundary at most WINDOW slots on, or the next one
    when a long row leaves none."""
    c = slot_row.size
    bounds = [p for p in range(c) if p == 0 or slot_row[p] < 0
              or slot_row[p] != slot_row[p - 1]] + [c]
    starts, i = [0], 0
    while bounds[i] < c:
        reach = [k for k in range(i + 1, len(bounds))
                 if bounds[k] <= bounds[i] + WINDOW]
        i = reach[-1] if reach else i + 1
        starts.append(bounds[i])
    return starts


@pytest.mark.parametrize("seed", range(4))
def test_row_index_packs_whole_short_rows_into_windows(seed):
    """The windows are the greedy packing: whole rows of at most WINDOW
    slots and slots of no row, at most WINDOW slots a window, and each
    long row alone in a span of its own."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 3 * WINDOW, 60)
    vm = _grouped_layout(rng, lengths)
    index = row_index(torch.from_numpy(vm), lengths.size)
    window = index.window.numpy()
    slot_row = index.slot_row.numpy()
    assert window.tolist() == _greedy_windows(slot_row)
    for a, b in zip(window[:-1], window[1:]):
        rows = set(slot_row[a:b].tolist()) - {-1}
        if b - a > WINDOW:
            assert rows == {slot_row[a]} and lengths[slot_row[a]] == b - a
        else:
            assert all(lengths[r] <= WINDOW for r in rows)


@pytest.mark.parametrize("vm", [[0, 1, 0], [0, -1, 0], [2, 2, 1, 2],
                                [1, 1, 0, 0, 1]])
def test_row_index_rejects_ungrouped_slots(vm):
    assert not validate_cloudlet_order(torch.tensor(vm))
    with pytest.raises(ValueError, match="grouped by vm"):
        row_index(torch.tensor(vm, dtype=torch.int32), 3)


def test_level2_memory_is_linear_in_slots_and_vms():
    """One VM holds as many slots as there are VMs: V * Kmax is 1,000x
    C + V.  The index holds O(C + V) elements, and no operation of the
    index build or the level-2 pass allocates V * Kmax bytes."""
    from torch.profiler import ProfilerActivity, profile

    nv = 4000
    lengths = np.ones(nv, np.int64)
    lengths[17] = 4 * nv
    vm = np.repeat(np.arange(nv, dtype=np.int32), lengths)
    c = vm.size
    assert nv * lengths.max() >= 1000 * (c + nv)
    rng = np.random.default_rng(0)
    rem = torch.from_numpy(rng.uniform(1.0, 10.0, c).astype(np.float32))
    run = torch.ones(c, dtype=torch.bool)
    cap = torch.full((nv,), 1000.0)
    pes = torch.ones(nv)
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        index = row_index(torch.from_numpy(vm), nv)
        rates, dt_min = simstep_ragged(rem, run, index, cap, pes, 1)
    held = sum(getattr(index, f.name).numel()
               for f in dataclasses.fields(index))
    assert held <= 3 * (c + nv)
    biggest = max(e.cpu_memory_usage for e in prof.events())
    assert 0 < biggest < nv * lengths.max()
    np.testing.assert_allclose(rates[vm == 17].numpy(), 1000.0 / (4 * nv),
                               rtol=1e-6)
    assert torch.all(dt_min < INF)
