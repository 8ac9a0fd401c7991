"""``launch.profile`` refuses a trace that cannot carry the device time
of a phase: no CUDA kernel at all, or fewer of the port's own kernels
than their launch counters counted during the phase.  (The profile
itself needs the card; its trace check runs here on stand-in events.)
"""
from types import SimpleNamespace

import pytest
import torch

from repro_torch.launch import profile

NONE = dict.fromkeys(profile.TRACED_KERNELS, 0)


def _events(*names):
    return [SimpleNamespace(name=n) for n in names]


def test_empty_trace_raises():
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        profile.check_trace([], "prefill", NONE)


def test_trace_short_of_counted_launches_raises():
    kernels = _events("void flash_tc_kernel<64>(CUtensorMap...)",
                      "ampere_bf16_s16816gemm", "void colsum_kernel<float>")
    counted = dict(NONE, flash_attention=2, gradstats_colsum=1)
    with pytest.raises(RuntimeError, match="flash_attention"):
        profile.check_trace(kernels, "prefill", counted)


def test_trace_with_every_counted_launch_passes():
    kernels = _events("void flash_tc_kernel<64>(CUtensorMap...)",
                      "void flash_fwd_kernel<float, 64>(...)",
                      "void scan_kernel<__nv_bfloat16, 4>(...)",
                      "void colsum_kernel<float>(...)",
                      "void moments_kernel<float>(...)", "elementwise")
    counted = dict(flash_attention=2, mamba_scan=1, gradstats_colsum=1,
                   gradstats_moments=1)
    assert profile.check_trace(kernels, "phase", counted) == counted


def test_step_annotation_is_not_a_kernel():
    """A scheduled session mirrors its step range on the device timeline;
    it spans every kernel of the step and would read as a busy device."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [SimpleNamespace(name="ProfilerStep*", device_type=cuda),
              SimpleNamespace(name="void colsum_kernel<float>(...)",
                              device_type=cuda),
              SimpleNamespace(name="aten::mm", device_type=cpu)]
    prof = SimpleNamespace(events=lambda: events)
    assert [e.name for e in profile._kernel_events(prof)] == [
        "void colsum_kernel<float>(...)"]
