"""The kernels' yardstick against hand-counted small cases, and the trace
reduction on made-up events."""

import types

import pytest
import torch

from portbench import roofline, trace
from portbench.trace import Event


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    assert roofline.bound_s(0, 34e12, "float64") == pytest.approx(1.0)


def test_slot_reduce_counts_every_row_once():
    contrib = torch.zeros(10, 6)  # 240 B
    perm = torch.zeros(10, dtype=torch.int32)  # 40 B
    offsets = torch.zeros(4, dtype=torch.int32)  # 16 B, 3 slots
    out = torch.zeros(3, 6)  # 72 B
    rec = roofline.slot_reduce_count((contrib, perm, offsets, 3, None), {}, out)
    assert rec == dict(bytes=240 + 40 + 16 + 72, flop=60, dtype="float32")
    assert roofline.slot_reduce_bound(rec) == pytest.approx(368 / 3.35e12)
    assert roofline.slot_reduce_count((torch.zeros(0, 6), perm[:0], offsets[:1], 0, None), {}, out[:0]) is None


def test_ell_pcg_counts_operations_by_the_iterations_run():
    nb, K, d = 5, 3, 6
    He, cols = torch.zeros(nb, K, d, d), torch.zeros(nb, K, dtype=torch.int32)
    Minv, b = torch.zeros(nb, d, d), torch.zeros(nb * d)
    out = types.SimpleNamespace(x=torch.zeros(nb * d), iterations=torch.tensor(7))
    rec = roofline.ell_pcg_count((He, cols, Minv, b, 1e-6, 100), {}, out)
    assert rec["bytes"] == (nb * K * 36 + nb * K + nb * 36 + 2 * nb * d) * 4
    per_iteration = 2 * nb * (K + 1) * 36 + 12 * nb * d  # the products, then the dots and updates
    assert rec["flop_per_iteration"] == per_iteration == 1800
    assert roofline.ell_pcg_bound(rec) == pytest.approx(max(rec["bytes"] / 3.35e12, 7 * 1800 / 67e12))


def test_ell_assemble_counts_factors_blocks_and_rows():
    nb, K, F = 3, 2, 2
    batch = types.SimpleNamespace(T_obs=torch.zeros(F, 4, 4), sqrt_info=torch.zeros(F, 6, 6), weight=torch.zeros(F),
                                  n_slots=2)
    poses, const = torch.zeros(nb, 4, 4), torch.zeros(nb, dtype=torch.bool)
    cols, idx = torch.zeros(nb, K, dtype=torch.int32), torch.zeros(F, 2, dtype=torch.int32)
    # 4 entries: two diagonal contributions of each factor, two of which name an off-diagonal slot
    entries = torch.tensor([[0, 1], [1, 0], [2, 1], [3, 0]], dtype=torch.int32)
    rows = torch.zeros(nb + 1, dtype=torch.int32)
    out = (torch.zeros(nb, K, 6, 6), torch.zeros(nb * 6), torch.zeros(()))
    rec = roofline.ell_assemble_count((poses, const, [batch], cols, idx, entries, rows, (0, F)), {}, out)
    inputs = (nb * 16 + F * 16 + F * 36 + F + nb * K + F * 2 + 8 + nb + 1) * 4 + nb
    outputs = (nb * K * 36 + nb * 6 + 1) * 4
    assert rec["bytes"] == inputs + outputs
    flop = 1700 * F + 72 * 2 * F + 648 * (4 + 2)
    assert roofline.ell_assemble_bound(rec) == pytest.approx(max(rec["bytes"] / 3.35e12, flop / 67e12))


def test_union_and_busy_time():
    assert trace.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    assert trace.union_ns([]) == 0
    dev = [Event("void k1<float>(int)", True, 0, 10), Event("void k1<float>(int)", True, 5, 20),
           Event("Memcpy DtoD (Device -> Device)", True, 30, 40), Event("aten::add", False, 0, 50)]
    s = trace.summarize(dev, 1e-7, 2)
    assert s.busy_s == pytest.approx(30e-9)
    assert len(s.kernels) == 2 and s.kernel_time_s(["k1"]) == pytest.approx(20e-9)
    assert s.device_ops[0] == ["k1", pytest.approx(25e-9)]


def test_idle_gaps_are_labelled_by_the_host():
    evts = [
        Event("portbench.linearize", False, 0, 100, 1), Event("aten::index", False, 10, 40, 1),
        Event("aten::mul", False, 50, 90, 1), Event("cudaLaunchKernel", False, 0, 200, 2),
        Event("k", True, 0, 20), Event("k", True, 30, 55), Event("k", True, 70, 80), Event("k", True, 150, 160),
    ]
    gaps = dict((n, t) for n, t in trace.idle_gaps(evts))
    # gaps: 20-30 in aten::index, 55-70 in aten::mul, 80-150 from aten::mul's span into the span's end
    assert gaps["linearize/aten::index"] == pytest.approx(10e-9)
    assert gaps["linearize/aten::mul"] == pytest.approx(85e-9)
