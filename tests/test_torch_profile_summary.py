"""chip_smoke.py's profiler summary (one walk of the kineto events) on a
hand-built event list, on the CPU.

The events stand in for kineto's (`name`, `device_type`, `start_ns`,
`end_ns`, `correlation_id`): kernels on the device, the
port wrappers' launch ranges on the host and their device side, launch
calls with and without a device record. `trace_records` +
`summarize_kernels` must give the device time and count of every kernel
(the ranges' device side left out), the matrix products' launches, the
port kernels' launches by device-side name, the launch calls, the lost
records inside each wrapper's range, and the ten longest kernels: each
against sums done by hand. `check_profiled_launches` stays as strict.
A split-K product's partial-product kernels count as matrix products,
its reduction does not (kernel names from the H100).
"""
import os
import sys

import pytest
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


class Ev:
    def __init__(self, name, dev, start, end, corr=0):
        self._n, self._d, self._s, self._e, self._c = name, dev, start, end, \
            corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c


CPU, GPU = DeviceType.CPU, DeviceType.CUDA
POOL = "void additive_pool_tc<64, 256>(float const*)"
GEMM = "nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NNT"
XMMA = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"
SPLITK = "void splitKreduce_kernel<32, 16, int, float>"
ADD = "void at::native::vectorized_elementwise_kernel<4, add>"


def _events():
    evs = [
        # the pool wrapper's range (host) and its device side
        Ev("additive_pool", CPU, 1000, 2000),
        Ev("additive_pool", GPU, 5000, 9000, 0),
        Ev("cudaLaunchKernel", CPU, 1100, 1200, 1),
        Ev(POOL, GPU, 5000, 6500, 1),
        Ev("cudaLaunchKernel", CPU, 1300, 1400, 2),     # lost in the trace
        # outside any wrapper: two GEMMs, a split-K reduction, an add
        Ev("cudaLaunchKernelExC", CPU, 3000, 3100, 3),
        Ev(GEMM, GPU, 10000, 30000, 3),
        Ev("cuLaunchKernel", CPU, 3200, 3300, 4),
        Ev(GEMM, GPU, 31000, 41000, 4),
        Ev("cudaLaunchKernel", CPU, 3400, 3500, 5),
        Ev(XMMA, GPU, 42000, 43000, 5),
        Ev("cudaLaunchKernel", CPU, 3600, 3700, 6),
        Ev(SPLITK, GPU, 43000, 43500, 6),
        Ev("cudaLaunchKernel", CPU, 3800, 3900, 7),
        Ev(ADD, GPU, 44000, 44250, 7),
        Ev("cudaLaunchKernel", CPU, 4000, 4100, 8),     # lost, no wrapper
        # host ops that are neither
        Ev("aten::mm", CPU, 2900, 3150, 0),
    ]
    return evs


def test_one_walk_sums_by_hand():
    trace = chip_smoke.trace_records(_events())
    assert trace["kernels"] == {
        POOL: {"count": 1, "ms": 1.5e-3}, GEMM: {"count": 2, "ms": 30e-3},
        XMMA: {"count": 1, "ms": 1e-3}, SPLITK: {"count": 1, "ms": 0.5e-3},
        ADD: {"count": 1, "ms": 0.25e-3}}
    assert trace["launch_calls"] == 8 and trace["device_records"] == 6
    assert trace["lost"] == 2
    assert trace["calls_by_wrapper"]["additive_pool"] == 2
    assert trace["lost_by_wrapper"]["additive_pool"] == 1
    assert trace["lost_by_wrapper"]["packed_attention"] == 0
    s = chip_smoke.summarize_kernels(trace["kernels"])
    assert s["busy_ms"] == pytest.approx(1.5e-3 + 30e-3 + 1e-3 + 0.5e-3
                                         + 0.25e-3)
    assert s["kernel_launches"] == 6
    assert s["gemm_launches"] == 3 and s["gemm_ms"] == pytest.approx(31e-3)
    pool = s["kernels"]["additive_pool"]
    assert pool["launches"] == 1 and pool["ms"] == pytest.approx(1.5e-3)
    assert pool["by_kernel"] == {"additive_pool_tc": 1,
                                 "additive_pool_kernel": 0,
                                 "additive_pool_long": 0}
    assert s["kernels"]["packed_attention"]["launches"] == 0
    assert [k["name"] for k in s["top_kernels"]] == [
        GEMM[:60], POOL[:60], XMMA[:60], SPLITK[:60], ADD[:60]]
    assert s["top_kernels"][0] == {"name": GEMM[:60], "count": 2,
                                   "ms": pytest.approx(30e-3)}


def test_launch_check_stays_strict():
    trace = chip_smoke.trace_records(_events())
    listed = {n: 0 for n in chip_smoke.KERNEL_NAMES}
    listed["additive_pool"] = 1
    counted = dict(listed, additive_pool=2)
    # one launch missing from the trace, and one lost record in its range
    assert chip_smoke.check_profiled_launches(listed, counted, trace) == 1
    with pytest.raises(RuntimeError):
        chip_smoke.check_profiled_launches(
            listed, dict(listed, additive_pool=3), trace)
    with pytest.raises(RuntimeError):
        chip_smoke.check_profiled_launches(
            listed, dict(listed, packed_attention=1), trace)
    with pytest.raises(RuntimeError):    # the profiler lists more
        chip_smoke.check_profiled_launches(
            dict(listed, additive_pool=2), listed, trace)


@pytest.mark.parametrize("name, gemm", [
    ("nvjet_tst_192x208_64x4_2x1_v_bz_coopB_NNT", True),
    # cuBLASLt's split-K partial products (the H100's names)
    ("nvjet_tst_128x128_64x6_2x2_h_bz_splitK_NTT", True),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3_warpsize"
     "1x2x1_ffma_aligna4_alignc4_execute_split_k_kernel__5x_cublas", True),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nt_align1>"
     "(cutlass_80_simt_sgemm_128x32_8x5_nt_align1::Params)", True),
    # the split-K reduction and other kernels
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16,"
     " float, __nv_bfloat16, false>(cublasLt::cublasSplitKParams<float>)",
     False),
    (ADD, False), (POOL, False)])
def test_split_k_products_count_as_gemms(name, gemm):
    """A product cuBLAS splits over K launches a partial-product kernel
    whose name says splitK: it counts as a matrix product; the reduction
    after it does not."""
    assert chip_smoke._is_gemm(name) is gemm
