"""Every registry bundle's step on the card against its ``meta`` trace,
at smoke size (``chip_smoke.py`` ``[bundles]`` runs the serve cells at
full width).

This file imports no JAX, so its ``cuda_only`` tests can run on a card
(``pytest --noconftest -m cuda_only tests/test_torch_bundles_cuda.py``).
For each (arch, shape) of the registry, at its smoke configuration and
shapes: one step on the card under ``launch.analysis``'s counter gives
the FLOPs of the ``meta`` trace of the same bundle exactly, calls the
same CUDA entries as often as the trace records (rows 8, 9, 10), and
``kernels.ops``' launch counters rise by those calls; its outputs are
finite.  ``run_cell(..., device="cuda")`` records the measured step.
"""
import pytest
import torch

from repro_torch.configs import common as TC
from repro_torch.launch import analysis as AN
from repro_torch.launch import dryrun as D

ROWS = ("flash_attention", "flash_decode", "embedding_bag")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cells():
    return [(a, s) for a in TC.list_archs() for s in TC.get(a).shapes]


@pytest.mark.cuda_only
@pytest.mark.parametrize("arch_id,shape", _cells())
def test_cuda_bundle_counts_equal_the_meta_trace(cuda_device, arch_id,
                                                 shape):
    arch = TC.get(arch_id)
    bundle = arch.build_bundle(arch.make_smoke_config(), shape, smoke=True)
    _, _, _, mtr = D.trace(bundle, device="meta")
    _, _, _, ctr = D.trace(bundle, device=cuda_device, measure=True)
    assert ctr.flops == mtr.flops
    assert ctr.flops_by_rate == mtr.flops_by_rate
    assert ctr.kernels == mtr.kernels
    want = AN.kernel_launches(mtr)
    launched = ctr.measured["launches"]
    assert {k: launched.get(k, 0) for k in ROWS} == \
        {k: want.get(k, 0) for k in ROWS}
    assert ctr.measured["finite"]
    assert ctr.measured["temp_bytes"] > 0 and ctr.measured["step_ms"] > 0


@pytest.mark.cuda_only
@pytest.mark.parametrize("arch_id,shape", [
    ("yi-9b", "train_4k"), ("yi-9b", "decode_32k"),
    ("two-tower-retrieval", "serve_p99")])
def test_cuda_run_cell_measures_the_step(cuda_device, arch_id, shape):
    rec = D.run_cell(arch_id, shape, "single", smoke=True, device="cuda")
    assert rec["status"] == "ok", rec.get("error")
    m = rec["measured"]
    assert m["finite"] and m["temp_bytes"] > 0 and m["step_ms"] > 0
    assert {k: v for k, v in m["launches"].items() if k in ROWS} == \
        {k: v for k, v in rec["kernels"].items() if k in ROWS}
