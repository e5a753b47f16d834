"""gemm_tflops.eval: the matrix products' operations of the profiled passes
(the kind's `gemm_flops`, counted from the cell's shapes) over the device
seconds of cuBLAS's product kernels in the trace."""
from portbench import trace


def read(run):
    if run.trace is None:
        return None
    flops = run.kind.gemm_flops(run.cfg, run.traffic)
    s = run.trace.kernel_s(trace.is_gemm)
    return flops * run.traced_units / s / 1e12 if flops and s else None
