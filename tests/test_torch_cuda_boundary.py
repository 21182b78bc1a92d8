"""The call boundary of the port's CUDA kernels (ops/_cuda.py), on the CPU.

Every hand-written kernel is launched through an Entry: its C signature
declared once, the tensors passed as pointers, the current stream
appended, a CUDA error raised, the launch counted. Here the library is a
stub: C function pointers made from Python callables (ctypes.CFUNCTYPE),
and the stream a stub handle, so no card and no compiler are needed.
The shared scratch-slot grouping of kernels B1 and B4
(sw_packed.scratch_slots) is held against the two copies it replaced.
"""
import ctypes
from types import SimpleNamespace

import pytest
import torch

from spacepharer_tpu_torch.logging import timings
from spacepharer_tpu_torch.ops import _cuda
from spacepharer_tpu_torch.ops._cuda import (I64, INT, INTS, PTR, Entry,
                                             check, expect, on_card)
from spacepharer_tpu_torch.ops.sw_packed import scratch_slots

STREAM = 0xBEEF
SIGNATURE = (PTR, INT, I64, INTS, PTR)


def _stub(monkeypatch, returns=0, **functions):
    """A stub library `stub` whose stub_launch takes SIGNATURE and the
    stream, records each call's arguments and returns `returns`; plus
    `functions` (its constant functions). Returns (calls, streams): the
    recorded arguments and the devices the stream was asked for."""
    calls, streams = [], []

    def launch(p, i, ll, ints, q, stream):
        calls.append((p, i, ll, (ints[0], ints[1]), q, stream))
        return returns

    proto = ctypes.CFUNCTYPE(ctypes.c_int, *SIGNATURE, PTR)
    lib = SimpleNamespace(stub_launch=proto(launch), **functions)
    monkeypatch.setitem(_cuda._libs, "stub", lib)
    monkeypatch.setattr(_cuda, "current_stream",
                        lambda dev: streams.append(dev) or STREAM)
    return calls, streams


def _counted(*names):
    t = timings()
    return [t.get(n, 0) for n in names]


def test_entry_passes_arguments_in_declared_order_stream_last(monkeypatch):
    calls, streams = _stub(monkeypatch)
    a = torch.arange(4, dtype=torch.int32)
    b = torch.zeros(3, dtype=torch.uint8)
    Entry("stub", "stub", SIGNATURE)(a, 7, 1 << 40, (3, -4), b)
    assert calls == [(a.data_ptr(), 7, 1 << 40, (3, -4), b.data_ptr(),
                      STREAM)]
    assert streams == [a.device]     # the first tensor's device


def test_entry_raises_naming_the_entry_on_a_cuda_error(monkeypatch):
    calls, _ = _stub(monkeypatch, returns=700)
    names = ("stub_k_launches", "stub_k_cells")
    before = _counted(*names)
    entry = Entry("stub", "stub", SIGNATURE, counter="stub_k",
                  cells_counter="stub_k_cells")
    with pytest.raises(RuntimeError,
                       match="stub kernel launch failed: CUDA error 700"):
        entry(torch.zeros(1), 0, 0, (0, 0), torch.zeros(1), cells=5)
    assert len(calls) == 1 and _counted(*names) == before


def test_entry_counts_launches_and_cells(monkeypatch):
    _stub(monkeypatch)
    names = ("stub_k_launches", "stub_k_cells", "stub_plain_launches")
    before = _counted(*names)
    x = torch.zeros(2)
    counted = Entry("stub", "stub", SIGNATURE, counter="stub_k",
                    cells_counter="stub_k_cells")
    counted(x, 1, 2, (0, 0), x, cells=100)
    counted(x, 1, 2, (0, 0), x, cells=23)
    Entry("stub", "stub", SIGNATURE)(x, 1, 2, (0, 0), x)
    assert [n - b for n, b in zip(_counted(*names), before)] == [2, 123, 0]


def test_entry_refuses_a_wrong_argument_count(monkeypatch):
    calls, _ = _stub(monkeypatch)
    with pytest.raises(TypeError, match="5 arguments declared, 4 given"):
        Entry("stub", "stub", SIGNATURE)(torch.zeros(1), 1, 2, (0, 0))
    assert calls == []


def test_entry_checks_its_constants_before_the_first_launch(monkeypatch):
    calls, _ = _stub(monkeypatch, stub_stripe=lambda: 16)
    x = torch.zeros(1)
    Entry("stub", "stub", SIGNATURE,
          constants={"stub_stripe": 16})(x, 0, 0, (0, 0), x)
    with pytest.raises(RuntimeError, match="stub_stripe is 16, this "
                                           "module's 32"):
        Entry("stub", "stub", SIGNATURE,
              constants={"stub_stripe": 32})(x, 0, 0, (0, 0), x)
    assert len(calls) == 1


def _layout(out):
    for k, v in enumerate((16, 1 << 14, 11)):
        out[k] = v


@pytest.mark.parametrize("constants, raises", [
    ({"stub_stripe": 16, "stub_layout": (16, 1 << 14, 11)}, False),
    ({"stub_stripe": 17}, True),
    ({"stub_layout": (16, 1 << 14, 12)}, True),
])
def test_expect_holds_constants_to_the_library(constants, raises):
    lib = SimpleNamespace(stub_stripe=lambda: 16, stub_layout=_layout)
    if raises:
        with pytest.raises(RuntimeError, match="who: the kernel's stub_"):
            expect(lib, "who", constants)
    else:
        expect(lib, "who", constants)


@pytest.mark.parametrize("case", ["dtype", "device", "contiguous", "numel"])
def test_check_raises_the_wrappers_messages(case):
    cpu = torch.device("cpu")
    x = torch.zeros((4, 3), dtype=torch.int32)
    check("who", "x", x, torch.int32, cpu, numel=12)
    bad = {"dtype": (x.long(), torch.int32, cpu, None),
           "device": (x, torch.int32, torch.device("meta"), None),
           "contiguous": (x.t(), torch.int32, cpu, None),
           "numel": (x, torch.int32, cpu, 5)}[case]
    want = ("who: x must have 5 elements, got 12" if case == "numel" else
            "who: x must be a contiguous torch.int32 tensor on")
    with pytest.raises(ValueError, match=want):
        check("who", "x", bad[0], bad[1], bad[2], numel=bad[3])


def test_on_card_takes_cpu_as_plain_and_refuses_other_devices():
    assert on_card("who", torch.zeros(1)) is False
    with pytest.raises(ValueError, match="who: unsupported device meta"):
        on_card("who", torch.zeros(1, device="meta"))


def _allpairs_grouping(q_lens, stripe, t_total, scratch_bytes):
    """sw_allpairs's own grouping before scratch_slots."""
    n_q = q_lens.numel()
    long_q = q_lens > stripe
    per_launch = max(1, scratch_bytes // (8 * t_total))
    slot = torch.full((n_q,), -1, dtype=torch.int32)
    group = torch.zeros(n_q, dtype=torch.int64)
    if bool(long_q.any()):
        rank = torch.cumsum(long_q.long(), 0) - 1
        slot[long_q] = (rank[long_q] % per_launch).int()
        group = torch.clamp_min(rank, 0) // per_launch
    n_slots = min(int(long_q.sum()), per_launch)
    bounds = [0] + (torch.nonzero(group[1:] != group[:-1]).flatten() + 1
                    ).tolist() + [n_q]
    return slot, n_slots, bounds


def _dense_grouping(q_lens, stripe, t_total, scratch_bytes):
    """sw_dense's own grouping before scratch_slots."""
    long_q = q_lens > stripe
    per_launch = max(1, scratch_bytes // (8 * t_total))
    n_slots = min(int(long_q.sum()), per_launch)
    rank = torch.cumsum(long_q.long(), 0) - 1
    slot = torch.where(long_q, rank % per_launch, -1).int()
    group = torch.clamp_min(rank, 0) // per_launch
    bounds = [0] + (torch.nonzero(group[1:] != group[:-1]).flatten()
                    + 1).tolist() + [q_lens.numel()]
    return slot, n_slots, bounds


# (query lengths, scratch bytes) with 100 packed target letters: 800 bytes
# are one slot a launch
SLOT_CASES = {
    "all_short": ([3, 16, 1, 9], 8000),
    "all_long": ([17, 40, 2300, 33, 99], 8000),
    "all_long_one_slot": ([17, 40, 2300], 800),
    "mixed_across_launches": ([2300, 16, 40, 5, 17, 18, 1, 64], 1600),
    "mixed_first_short": ([4, 20, 3, 30, 2, 40, 1], 800),
}


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_scratch_slots_match_both_old_groupings(case):
    lens, scratch_bytes = SLOT_CASES[case]
    q_lens = torch.tensor(lens, dtype=torch.int64)
    got = scratch_slots(q_lens, 16, 100, scratch_bytes)
    for old in (_allpairs_grouping, _dense_grouping):
        slot, n_slots, bounds = old(q_lens, 16, 100, scratch_bytes)
        assert torch.equal(got[0], slot) and got[0].dtype == torch.int32
        assert got[1:] == (n_slots, bounds)
    long_q = [n > 16 for n in lens]
    per_launch = max(1, scratch_bytes // 800)
    assert len(got[2]) - 1 == max(1, -(-sum(long_q) // per_launch))
