"""attention_roofline.eval: the packed attention's least time (portbench/
work.py `attention_bound_s` of every launch of the profiled passes, the
launches counted by the kind from the cell's shapes) over the device time
of the kernels launched inside the attention wrapper's ranges, in %."""
from portbench import work
from portbench.readers import wrapper_roofline


def read(run):
    D = run.cfg["reference"].get("dim", 0)
    return wrapper_roofline(
        run, "packed_attention",
        [work.attention_bound_s(B, T, D)
         for B, T in run.kind.attention_calls(run.cfg, run.traffic)])
