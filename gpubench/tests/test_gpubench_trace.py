"""The trace's reduction on a made-up trace of two cards: each kernel in
the span open at its launch, busy time as each card's union of
intervals averaged over the cards, and the kernel-name rule on names that
the card's traces carry."""

from types import SimpleNamespace

import pytest


def _event(name, start, dur, *, cuda=False, corr=0, linked=0, card=0):
    from torch.autograd import DeviceType

    kind = DeviceType.CUDA if cuda else DeviceType.CPU
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
                           device_type=lambda: kind, correlation_id=lambda: corr,
                           linked_correlation_id=lambda: linked, device_index=lambda: card)


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_gpubench_trace_reduces_each_card_apart():
    from gpubench import trace

    ev = [
        _event("bench.window", 0, 1000),
        _event("bench.force", 100, 300),
        _event("bench.rebuild", 500, 100),
        _event("cudaLaunchKernel", 150, 1, corr=1),
        _event("cudaLaunchKernel", 160, 1, corr=2),
        _event("cudaLaunchKernel", 510, 1, corr=3),
        _event("k1_fwd_kernel", 200, 400, cuda=True, corr=1, card=0),
        _event("k1_fwd_kernel", 300, 200, cuda=True, corr=2, card=1),
        _event("void at::native::gather", 550, 100, cuda=True, corr=3, card=0),
    ]
    t = trace.reduce(_prof(ev), n_devices=2)
    assert t.window_s == pytest.approx(1000e-9)
    # card 0 busy 200-650 (450 ns), card 1 300-500 (200 ns): mean 325 ns
    assert t.busy_s == pytest.approx(325e-9)
    assert t.by_span["bench.force"] == pytest.approx(600e-9)
    assert t.own_by_span["bench.force"] == pytest.approx(600e-9)
    assert t.by_span["bench.rebuild"] == pytest.approx(100e-9)
    assert t.own_s == pytest.approx(600e-9) and t.cards == [0, 1]
    assert sum(t.idle.values()) == pytest.approx(1000e-9 - 325e-9)
    # a cell of four cards on which two ran nothing: those idle all the window
    assert trace.reduce(_prof(ev), n_devices=4).busy_s == pytest.approx(650e-9 / 4)


@pytest.mark.parametrize("name, library", [
    ("void (anonymous namespace)::k1_bwd_kernel<0, 40, float>((anonymous namespace)::K1T<float>)",
     False),
    ("void (anonymous namespace)::k3_fwd_kernel<1, 2, true, false>((anonymous namespace)::K3P)",
     False),
    ("void (anonymous namespace)::indexing_backward_kernel_small_stride<float>(long const*, long",
     True),
    ("void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, long",
     True),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x128x8_stage3_warpsize1x4x1_ffma", True),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nt_align1>(cutlass_80_simt", True),
    ("Memcpy PtoP (Device -> Device)", True),
])
def test_gpubench_kernel_name_rule(name, library):
    from gpubench import trace

    assert trace.is_library(name) is library
