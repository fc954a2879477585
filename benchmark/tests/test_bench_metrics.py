"""The trace reduction and the metric readers on a canned profiler table."""

import types

import pytest
import torch

from benchmark import counts, profiling
from benchmark.spec import Spec

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _event(name, start, end, device):
    return types.SimpleNamespace(
        name=name, device_type=device,
        time_range=types.SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _canned():
    """Times in microseconds: a CF phase [0, 100) with K1 (its unit
    kernel 30 us and fixup 10 us), an NCCL kernel (20 us) and a gemm on a
    second stream overlapping K1 (10 us); a KG phase [100, 200) with two
    kernels (10 us and 5 us) and a host op over the idle gap between
    them."""
    return _Prof([
        _event("bench.cf_phase", 0, 100, CPU),
        _event("bench.kg_phase", 100, 200, CPU),
        _event("cudaGraphLaunch", 125, 190, CPU),
        _event("bench.cf_phase", 0, 100, CUDA),   # mirrored range: skipped
        _event("void csr_units_kernel<float>", 10, 40, CUDA),
        _event("void gemm", 30, 40, CUDA),
        _event("void fixup_kernel<>", 40, 50, CUDA),
        _event("ncclDevKernel_AllReduce", 60, 80, CUDA),
        _event("void kg", 120, 130, CUDA),
        _event("void kg2", 180, 185, CUDA),
    ])


def test_the_trace_reduction():
    dev = profiling.read(_canned())
    # 10-50, 60-80, 120-130, 180-185
    assert dev["busy_s"] == pytest.approx(75e-6)
    assert dev["kernels"]["void gemm"] == pytest.approx([10e-6, 1])
    assert "bench.cf_phase" not in dev["kernels"]
    cf = dev["spans"]["cf_phase"]
    assert cf["count"] == 1 and cf["seconds"] == pytest.approx(100e-6)
    assert cf["kernels"]["ncclDevKernel_AllReduce"] == pytest.approx(
        [20e-6, 1])
    assert "void kg" in dev["spans"]["kg_phase"]["kernels"]
    idle = dict(dev["breakdown"]["idle_gaps"])
    # 50-60 and 80-120 start in the CF phase; 130-180 in the KG phase,
    # while the host launches a graph.
    assert idle["bench.cf_phase"] == pytest.approx(50e-6)
    assert idle["bench.kg_phase/cudaGraphLaunch"] == pytest.approx(50e-6)
    ops = dev["breakdown"]["device_ops"]
    assert ops[0] == ["void csr_units_kernel<float>", pytest.approx(30e-6)]


SIZES = {"n_nodes": 1000, "n_pairs": 5000, "n_edges": 6000,
         "n_node_rel": 3000}
MODEL = {"embed_dim": 64, "relation_dim": 64, "conv_dims": [64, 32, 16],
         "aggregator": "bi-interaction", "compute_dtype": "bf16"}
TRAIN = {"cf_batch_size": 1024, "kg_batch_size": 2048}


def _run(devices):
    return {"cell": "c", "model": MODEL, "train": TRAIN, "sizes": SIZES,
            "window": {"seconds": 4.0, "epochs": 2},
            "spans": {"cf_phase": [0.5, 100], "kg_phase": [0.25, 50],
                      "refresh": [0.012, 3]},
            "steps": {"cf": 10, "kg": 20}, "devices": devices}


def _read(name, run):
    return Spec().reader(name)(run)


def test_the_readers_on_canned_readings():
    dev = profiling.read(_canned())
    dev.update(untraced_s=200e-6, window_s=250e-6)
    run = _run([dev])
    assert _read("train.cf_step_ms", run) == pytest.approx(5.0)
    assert _read("train.kg_step_ms", run) == pytest.approx(5.0)
    assert _read("recommend.refresh_ms", run) == pytest.approx(4.0)
    # busy 75 us of a traced 250 us.
    assert _read("device.idle_share.train", run) == pytest.approx(70.0)
    assert _read("device.idle_share.serve", run) == pytest.approx(70.0)
    least = counts.k1_least_s_per_cf_step(SIZES, MODEL) * 10
    assert _read("ops.k1_roofline", run) == pytest.approx(
        100 * least / 40e-6)
    flops = counts.epoch_flops(SIZES, MODEL, TRAIN, 10, 20)
    assert _read("train.epoch_mfu", run) == pytest.approx(
        100 * flops / 2.0 / 67e12)
    # Across processes: the worst idle, the least NCCL time a CF step.
    # The first card's NCCL kernel (20 us) counts as idle: (75 - 20) busy
    # of 200; the second's 40 busy, 20 of them NCCL.
    other = dict(dev, busy_s=40e-6, kernels={"ncclX": [20e-6, 1]},
                 spans={"cf_phase": {"kernels": {"ncclX": [60e-6, 3]}}})
    run = _run([dev, other])
    assert _read("multihost.idle_share_max", run) == pytest.approx(90.0)
    assert _read("parallel.collective_ms", run) == pytest.approx(20e-6 / 10
                                                                 * 1e3)


def test_readers_without_a_reading_give_none():
    empty = {"kernels": {}, "busy_s": 0.0, "spans": {}, "untraced_s": 1.0,
             "window_s": 1.0}
    run = _run([empty])
    run["spans"] = {}
    for name in ("train.cf_step_ms", "train.kg_step_ms", "ops.k1_roofline",
                 "train.epoch_mfu", "device.idle_share.train",
                 "device.idle_share.serve", "recommend.refresh_ms",
                 "multihost.idle_share_max", "parallel.collective_ms"):
        assert _read(name, run) is None, name


def test_the_k1_count_is_what_the_data_needs():
    # One layer's forward at d = 64 in bf16: x once, 8 bytes a pair, the
    # offsets and the float32 output.
    assert counts.spmm_bytes(1000, 5000, 1000, 64, 2) == (
        1000 * 64 * 2 + 5000 * 8 + 1001 * 4 + 1000 * 64 * 4)
